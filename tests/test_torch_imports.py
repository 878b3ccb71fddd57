"""The port stands alone: no module of ``fiber_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, or names a module of
the JAX package in a string (a worker command such as ``python -m
fiber_tpu.worker`` or a backend registry entry would start the JAX
package's code without an import statement). Checked by reading the
sources, because JAX may already sit in ``sys.modules`` of any
interpreter that runs the tests; and at run time, in fresh processes:
a port pool's worker loads neither JAX nor the JAX package, and
``import fiber_tpu_torch`` loads no torch until a device-plane name is
used."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "fiber_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "fiber_tpu")


#: a module of the JAX package named in a string: ``fiber_tpu`` or a
#: dotted path below it, as a whole word (not a file path, not
#: ``fiber_tpu_torch``)
_JAX_PACKAGE_MODULE = re.compile(
    r"(?<![\w/.-])fiber_tpu(?:\.[A-Za-z_]\w*)*(?![\w/-])")


def _docstrings(tree) -> set:
    """The docstring constants of a module, class or function, which
    may name the JAX package's modules as documentation."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                out.add(id(first.value))
    return out


def forbidden_imports(source: str) -> list:
    bad = []
    tree = ast.parse(source)
    skip = _docstrings(tree)  # and the names the import calls report
    for node in ast.walk(tree):
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
            skip.add(id(node.args[0]))
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in skip):
            bad += _JAX_PACKAGE_MODULE.findall(node.value)
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
            "fiber_tpu_torch/utils/profiling.py",
            "fiber_tpu_torch/pool.py", "fiber_tpu_torch/worker.py",
            "fiber_tpu_torch/serialization.py",
            "fiber_tpu_torch/backends/__init__.py",
            "fiber_tpu_torch/launcher.py", "fiber_tpu_torch/managers.py",
            "fiber_tpu_torch/utils/wire.py",
            "fiber_tpu_torch/parallel/ring.py",
            "fiber_tpu_torch/experimental/__init__.py",
            "fiber_tpu_torch/examples/poet_distributed.py",
            "fiber_tpu_torch/examples/ring_allreduce.py",
            "fiber_tpu_torch/examples/pod_es_ring.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_fiber_tpu_imports(path):
    assert forbidden_imports(path.read_text()) == []


def test_guard_catches_every_form():
    src = ("import jax\nimport jax.numpy as jnp\nfrom jax import lax\n"
           "from fiber_tpu.ops import es\nimport fiber_tpu\n"
           "import importlib\nimportlib.import_module('fiber_tpu.models')\n"
           "import fiber_tpu_torch\nfrom fiber_tpu_torch.ops import es\n"
           "from . import x\n"
           "cmd = [sys.executable, '-m', 'fiber_tpu.worker']\n"
           "MODULES = {'local': 'fiber_tpu.backends.local'}\n"
           "log = logging.getLogger('fiber_tpu')\n"
           "ok = ['fiber_tpu_torch.worker', 'see fiber_tpu/pool.py', "
           "'fiber-tpu', '~/.fiber_tpu_torch/x']\n"
           "def f():\n    'A docstring may say fiber_tpu.pool.'\n")
    assert forbidden_imports(src) == [
        "jax", "jax.numpy", "jax", "fiber_tpu.ops", "fiber_tpu",
        "fiber_tpu.models", "fiber_tpu.worker", "fiber_tpu.backends.local",
        "fiber_tpu"]


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT), FIBER_BACKEND="local")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_the_package_and_its_pool_import_no_torch():
    """``import fiber_tpu_torch`` and its context API load no torch (a
    host worker would pay for it at every start), nor do the managers,
    the ring and its ``HostRing`` (a numpy-only ring rank); the first
    device-plane name does."""
    out = _run(
        "import sys, fiber_tpu_torch\n"
        "fiber_tpu_torch.Pool, fiber_tpu_torch.Process\n"
        "fiber_tpu_torch.Manager, fiber_tpu_torch.AsyncManager\n"
        "import fiber_tpu_torch.pool, fiber_tpu_torch.worker\n"
        "import fiber_tpu_torch.managers, fiber_tpu_torch.experimental\n"
        "from fiber_tpu_torch.parallel import Ring\n"
        "from fiber_tpu_torch.ops import HostRing\n"
        "before = 'torch' in sys.modules\n"
        "fiber_tpu_torch.CartPole\n"
        "jaxish = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'fiber_tpu')]\n"
        "print(before, 'torch' in sys.modules, jaxish)\n")
    assert out == "False True []"


def test_every_name_of_the_package_resolves():
    """Every name of ``__all__`` resolves; importing the submodule
    ``entry`` does not hide the function ``entry``."""
    import fiber_tpu_torch
    import fiber_tpu_torch.entry  # noqa: F401

    for name in fiber_tpu_torch.__all__:
        assert getattr(fiber_tpu_torch, name) is not None, name
    from fiber_tpu_torch import entry

    assert callable(entry) and entry.__module__ == "fiber_tpu_torch.entry"


def test_a_port_worker_loads_neither_jax_nor_the_jax_package():
    """A port pool's workers report what they loaded: no JAX, no JAX
    package, and no torch for a task that needs none."""
    out = _run(
        "import fiber_tpu_torch\n"
        "from tests import _torch_pool_tasks as tasks\n"
        "if __name__ == '__main__':\n"
        "    with fiber_tpu_torch.Pool(2) as pool:\n"
        "        seen = pool.map(tasks.loaded_modules, range(4), "
        "chunksize=1)\n"
        "    print(sorted(set(sum(seen, []))))\n")
    assert out == "[]"


#: modules that the copies name lazily and that later slices port
UNPORTED = ("fiber_tpu_torch.store.ledger", "fiber_tpu_torch.sched.hier",
            "fiber_tpu_torch.telemetry.export",
            "fiber_tpu_torch.telemetry.explain",
            "fiber_tpu_torch.backends.tpu")


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_modules_fail_loudly(name):
    import importlib

    with pytest.raises(ModuleNotFoundError):
        importlib.import_module(name)


def test_the_pool_paths_reach_no_unported_module():
    """A finder on ``sys.meta_path`` records every attempt to import a
    module of ``UNPORTED`` while host and device maps run through every
    map variant; a swallowed ``ModuleNotFoundError`` would show here."""
    out = _run(
        "import sys\n"
        f"UNPORTED = {UNPORTED!r}\n"
        "tried = []\n"
        "class Recorder:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name in UNPORTED:\n"
        "            tried.append(name)\n"
        "        return None\n"
        "sys.meta_path.insert(0, Recorder())\n"
        "import numpy as np, fiber_tpu_torch\n"
        "from tests import _torch_pool_tasks as tasks\n"
        "@fiber_tpu_torch.meta(device=True)\n"
        "def dev(w, x):\n"
        "    return (w * x).sum()\n"
        "if __name__ == '__main__':\n"
        "    w = np.ones(20000, np.float32)\n"
        "    with fiber_tpu_torch.Pool(2, device='cpu') as pool:\n"
        "        pool.map(tasks.square, range(8))\n"
        "        list(pool.imap(tasks.square, range(8)))\n"
        "        list(pool.imap_unordered(tasks.square, range(8)))\n"
        "        pool.apply_async(tasks.add, (1, 2)).get(30)\n"
        "        pool.starmap(dev, [(w, np.float32(i)) for i in range(4)])\n"
        "        pool.stats(); pool.device_stats()\n"
        "    print(tried)\n")
    assert out == "[]"
