"""The host plane's copied modules stay copies.

Most of ``fiber_tpu_torch``'s host plane (transport, scheduler, store,
telemetry, health, processes, queues) is the JAX package's pure-Python
code with the package renamed. For each such module the port's file and
the JAX package's must have equal syntax trees once docstrings are
stripped and every whole word ``fiber_tpu`` of the JAX package's source
(imports, logger names, default paths) reads ``fiber_tpu_torch`` and
every string that starts ``fiber-`` (thread names, temporary files,
record schemas; not the ``fiber-tpu`` command) starts ``fiber-torch-``.
The modules that really changed are listed in ``PORTED`` and are read as
ports; every module of the port that has a counterpart in the JAX package
is in one list or the other.
"""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "fiber_tpu"
PORT = ROOT / "fiber_tpu_torch"

COPIED = [
    "admin.py", "auth.py", "backends/__init__.py", "backends/local.py",
    "config.py", "context.py", "core.py", "framing.py", "health.py",
    "host_agent.py", "launcher.py", "meta.py", "process.py", "queues.py",
    "sched/__init__.py", "sched/core.py", "store/__init__.py",
    "store/core.py", "store/plane.py", "store/replicate.py",
    "telemetry/__init__.py", "telemetry/accounting.py",
    "telemetry/archive.py", "telemetry/flightrec.py",
    "telemetry/metrics.py", "telemetry/monitor.py", "telemetry/policy.py",
    "telemetry/postmortem.py", "telemetry/profiler.py", "telemetry/slo.py",
    "telemetry/timeseries.py", "telemetry/tracing.py",
    "testing/__init__.py", "testing/chaos.py", "transport/__init__.py",
    "transport/evloop.py", "transport/shm.py", "transport/tcp.py",
    "utils/__init__.py", "utils/logging.py", "utils/net.py",
    "utils/serve.py", "utils/staging.py", "worker.py",
]

#: modules whose code changed in the port: the package root (lazy
#: device-plane names), the managers' wire, the pump's build directory,
#: the helpers without XLA's flags, the tensor reducer, DEVICE on CUDA,
#: the CUDA device tier, the pool's device routing, the ring's
#: torch.distributed initializer, and the device plane proper
PORTED = [
    "__init__.py", "managers.py", "_native/__init__.py", "utils/misc.py",
    "serialization.py", "telemetry/device.py", "store/device_tier.py",
    "pool.py", "utils/profiling.py", "utils/flops.py",
    "utils/checkpoint.py", "parallel/__init__.py", "parallel/dmap.py",
    "parallel/mesh.py", "models/__init__.py", "models/envs.py",
    "models/policies.py", "models/transformer.py", "ops/__init__.py",
    "ops/cma.py", "ops/collectives.py", "ops/dma_ring.py", "ops/es.py",
    "ops/map_elites.py", "ops/novelty.py", "ops/pgpe.py", "ops/poet.py",
    "ops/ring_attention.py", "ops/ulysses_attention.py",
    "parallel/ring.py", "experimental/__init__.py",
]

#: the one line of ``managers.py`` that the port changed: its connections
#: pickle with the port's serialization (``utils/wire.py``), since
#: ``torch.multiprocessing``'s reducers on the stdlib connection's
#: pickler send tensors as handles that the manager's server cannot
#: hand on
MANAGERS_WIRE = (
    "from multiprocessing.connection import Client, Listener\n",
    "from fiber_tpu_torch.utils.wire import Client, Listener\n")


def _strip_docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant) and isinstance(
                        body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _normal(source: str) -> str:
    return ast.dump(_strip_docstrings(ast.parse(source)))


def _renamed(source: str) -> str:
    """The JAX package's source as the port names things: the package,
    and the ``fiber-`` names of threads, temporary files and record
    schemas, which would otherwise collide with the JAX package's in a
    process that runs both (the JAX package's tests count its
    ``fiber-evloop`` and ``fiber-admin`` threads by name)."""
    source = re.sub(r"\bfiber_tpu\b", "fiber_tpu_torch", source)
    return re.sub(r"(?<=[\"'])fiber-(?!tpu)", "fiber-torch-", source)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_the_jax_packages(rel):
    ours = (PORT / rel).read_text()
    theirs = _renamed((REF / rel).read_text())
    assert _normal(ours) == _normal(theirs), (
        f"fiber_tpu_torch/{rel} drifted from fiber_tpu/{rel}; port the "
        "change, or move the module to PORTED if it is now a port")


def test_managers_differ_from_the_jax_packages_only_in_their_wire():
    """The managers are the JAX package's module but for the import of
    ``Client`` and ``Listener``; that import sits among the module's
    first-party imports, where the check below moves it."""
    theirs = _renamed((REF / "managers.py").read_text())
    old, new = MANAGERS_WIRE
    assert theirs.count(old) == 1
    anchor = "from fiber_tpu_torch.utils.serve import serve_authenticated\n"
    theirs = theirs.replace(old, "").replace(anchor, anchor + new)
    assert _normal((PORT / "managers.py").read_text()) == _normal(theirs)


def test_the_native_pump_source_is_the_jax_packages():
    assert (PORT / "_native/pump.cpp").read_bytes() \
        == (REF / "_native/pump.cpp").read_bytes()


def test_every_counterpart_is_copied_or_ported():
    counterparts = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                    if (REF / p.relative_to(PORT)).is_file()}
    assert not set(COPIED) & set(PORTED)
    assert counterparts == set(COPIED) | set(PORTED)


def test_the_check_sees_a_changed_line():
    """A copy with one changed constant, or one import of the JAX
    package left in place, is not equal to its original."""
    theirs = _renamed((REF / "framing.py").read_text())
    assert _normal(theirs.replace("0xFB", "0xFC", 1)
                   if "0xFB" in theirs else theirs + "\nX = 1\n") \
        != _normal(theirs)
    ours = (PORT / "meta.py").read_text().replace(
        "from __future__ import annotations",
        "from __future__ import annotations\nimport fiber_tpu", 1)
    assert _normal(ours) != _normal(_renamed((REF / "meta.py").read_text()))
