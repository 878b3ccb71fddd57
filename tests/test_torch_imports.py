"""The port stands alone: no module of ``fiber_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package. Checked by reading the
sources, because JAX may already sit in ``sys.modules`` of any
interpreter that runs the tests."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "fiber_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "fiber_tpu")


def forbidden_imports(source: str) -> list:
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and _forbidden(node.args[0].value)):
            bad.append(node.args[0].value)
    return bad


def test_port_files_exist():
    assert len(FILES) > 10
    assert all(f.is_file() for f in FILES)
    # the modules of every slice are among those checked
    names = {str(f.relative_to(ROOT)) for f in FILES}
    assert {"fiber_tpu_torch/ops/poet.py", "fiber_tpu_torch/models/envs.py",
            "fiber_tpu_torch/models/policies.py", "fiber_tpu_torch/entry.py",
            "fiber_tpu_torch/ops/es.py", "chip_smoke.py",
            "fiber_tpu_torch/utils/checkpoint.py",
            "fiber_tpu_torch/utils/profiling.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_fiber_tpu_imports(path):
    assert forbidden_imports(path.read_text()) == []


def test_guard_catches_every_form():
    src = ("import jax\nimport jax.numpy as jnp\nfrom jax import lax\n"
           "from fiber_tpu.ops import es\nimport fiber_tpu\n"
           "import importlib\nimportlib.import_module('fiber_tpu.models')\n"
           "import fiber_tpu_torch\nfrom fiber_tpu_torch.ops import es\n"
           "from . import x\n")
    assert forbidden_imports(src) == [
        "jax", "jax.numpy", "jax", "fiber_tpu.ops", "fiber_tpu",
        "fiber_tpu.models"]
