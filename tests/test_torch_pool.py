"""The port's host plane (``fiber_tpu_torch.Pool``, ``Process``,
``SimpleQueue``, ``Pipe``) against the JAX package's on the CPU.

The same pure-Python task functions (``tests/_torch_pool_tasks.py``),
on inputs made from a numpy seed, go through ``fiber_tpu.Pool(2)`` and
``fiber_tpu_torch.Pool(2)`` by every map variant; the results must be
equal, and a task's exception must come back as each package's
``RemoteError`` around the same exception. The JAX pool runs once, in a
module fixture that closes it before the first test, because the suite's
leak check allows no JAX-package process to outlive a test; the port's
tests share one module-scoped pool.
"""

import threading
import time

import numpy as np
import pytest

import fiber_tpu
import fiber_tpu_torch
from tests import _torch_pool_tasks as tasks
from tests import targets

ROWS = list(np.random.default_rng(0).standard_normal((12, 5)))


def bounded(fn, timeout=120.0):
    """``fn()``, run on a thread and waited for at most ``timeout``
    seconds: a pool call that never returns fails its test instead of
    stalling the whole run (pool calls take no timeout of their own)."""
    box = {}

    def run():
        try:
            box["out"] = (True, fn())
        except BaseException as err:  # noqa: BLE001 - re-raised below
            box["out"] = (False, err)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout)
    if thread.is_alive():
        raise TimeoutError(f"pool call still running after {timeout} s")
    ok, value = box["out"]
    if not ok:
        raise value
    return value


def _call(fn):
    """``fn()``'s value, or what its exception looks like across a
    package boundary (the message's first line: the rest is the remote
    traceback, whose paths name each package)."""
    try:
        return "ok", bounded(fn)
    except TimeoutError:
        raise
    except Exception as err:  # noqa: BLE001 - compared below
        original = getattr(err, "original", None)
        return "raised", (type(err).__name__, type(original).__name__,
                          str(err).splitlines()[0])


CALLS = {
    "map": lambda p: p.map(tasks.square, range(40)),
    "map_chunks": lambda p: p.map(tasks.square, range(50), chunksize=3),
    "starmap": lambda p: p.starmap(tasks.add,
                                   [(i, 2 * i) for i in range(15)]),
    "imap": lambda p: list(p.imap(tasks.square, range(25), chunksize=4)),
    "imap_unordered": lambda p: sorted(
        p.imap_unordered(tasks.square, range(25), chunksize=4)),
    "apply_async": lambda p: [p.apply_async(tasks.add, (i, 10)).get(30)
                              for i in range(3)],
    "numpy": lambda p: p.map(tasks.row_stats, ROWS, chunksize=5),
    "error": lambda p: p.map(tasks.raise_on_even, range(4)),
}


def _wait_no_children(active_children, timeout=15.0):
    deadline = time.monotonic() + timeout
    while active_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert active_children() == []


@pytest.fixture(scope="module")
def jax_results():
    """Every call of ``CALLS`` through the JAX package's pool, which is
    closed and joined before any test runs."""
    pool = fiber_tpu.Pool(2)
    try:
        out = {name: _call(lambda: call(pool)) for name, call in CALLS.items()}
    finally:
        pool.terminate()
        pool.join()
    _wait_no_children(fiber_tpu.active_children)
    return out


@pytest.fixture(scope="module")
def pool():
    p = fiber_tpu_torch.Pool(2)
    yield p
    p.terminate()  # a stuck call must not stall the teardown
    p.join()
    _wait_no_children(fiber_tpu_torch.active_children)


def _same(got, want):
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        assert np.array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("name", list(CALLS))
def test_host_calls_match_the_jax_package(name, pool, jax_results):
    got = _call(lambda: CALLS[name](pool))
    want = jax_results[name]
    assert got[0] == want[0]
    _same(got[1], want[1])
    if name == "error":
        assert got[1][:2] == ("RemoteError", "ValueError")
        assert "even input 0" in got[1][2]


def test_killed_worker_task_is_resubmitted(pool, tmp_path):
    """A task that SIGKILLs its worker once: the resilient pool resubmits
    the dead worker's chunk and the map completes, as in the JAX
    package's ``test_resilient_resubmission_on_worker_death``."""
    marker = str(tmp_path / "died")
    got = bounded(lambda: pool.starmap(
        tasks.die_once, [(marker, i) for i in range(30)], chunksize=1))
    assert got == list(range(30))
    with open(marker) as fh:
        assert fh.read() == "died"


def test_tensors_cross_the_wire_as_tensors(pool):
    """Tensor arguments and results through host workers: values, dtype,
    shape and requires_grad arrive, and a bf16 tensor comes back bf16."""
    import torch

    g = torch.Generator().manual_seed(0)
    ts = [torch.randn(64, 32, generator=g),
          torch.randn(300, 300, generator=g).to(torch.bfloat16),
          torch.randn(7, 9, generator=g).t(),
          torch.randn(5, generator=g).requires_grad_()]
    views = bounded(lambda: pool.map(tasks.tensor_roundtrip, ts,
                                     chunksize=1))
    for t, view in zip(ts, views):
        assert view["dtype"] == str(t.dtype)
        assert view["shape"] == tuple(t.shape)
        assert view["requires_grad"] == t.requires_grad
        assert view["sum"] == float(t.detach().double().sum())
        assert view["back"].dtype == t.dtype
        assert torch.equal(view["back"], t.detach() + 1)
    outs = bounded(lambda: pool.starmap(tasks.tensor_affine,
                                        [(t, 3) for t in ts[:2]]))
    for t, (out, where) in zip(ts, outs):
        assert where == "cpu" and torch.equal(out, t * 2 + 3)


@pytest.mark.parametrize("case", ["ok", "raises", "terminated"])
def test_process_exit_codes(case):
    """0, 1 and -15, as ``tests/test_process.py`` holds the JAX
    package's processes."""
    target = {"ok": targets.noop, "raises": targets.raise_error,
              "terminated": targets.sleep_forever}[case]
    p = fiber_tpu_torch.Process(target=target)
    assert p.exitcode is None
    p.start()
    if case == "terminated":
        assert p.is_alive()
        p.terminate()
    p.join(30)
    assert not p.is_alive()
    assert p.exitcode == {"ok": 0, "raises": 1, "terminated": -15}[case]
    assert p not in fiber_tpu_torch.active_children()


def test_simple_queue_and_pipe_round_trips():
    """In the process, then through a worker process: a SimpleQueue pair
    squares numbers, a duplex Pipe echoes, as the JAX package's queue
    tests run them."""
    q = fiber_tpu_torch.SimpleQueue()
    q.put({"a": np.arange(3)})
    got = q.get(5)
    assert list(got) == ["a"] and np.array_equal(got["a"], np.arange(3))
    q.close()

    q_in, q_out = fiber_tpu_torch.SimpleQueue(), fiber_tpu_torch.SimpleQueue()
    parent, child = fiber_tpu_torch.Pipe()
    workers = [
        fiber_tpu_torch.Process(target=targets.queue_worker,
                                args=(q_in, q_out)),
        fiber_tpu_torch.Process(target=targets.pipe_echo, args=(child,)),
    ]
    for w in workers:
        w.start()
    for i in range(5):
        q_in.put(i)
    q_in.put(None)
    assert sorted(q_out.get(30) for _ in range(5)) == [0, 1, 4, 9, 16]
    parent.send(42)
    assert parent.recv(30) == ("echo", 42)
    parent.send(None)
    for w in workers:
        w.join(30)
        assert w.exitcode == 0
        assert w not in fiber_tpu_torch.active_children()
    for end in (q_in, q_out, parent):
        end.close()


# -- the device broadcast's raw key ------------------------------------------

#: 2.4 MB of f32: three of the key's 1 MB chunks, the last one partial
BCAST = np.random.default_rng(3).standard_normal(600_000).astype(np.float32)


def _key_forms():
    a = BCAST
    return {"contiguous": a, "copy": a.copy(),
            "new": np.frombuffer(a.tobytes(), dtype=np.float32),
            "strided": np.repeat(a, 2)[::2]}


@pytest.mark.parametrize("form", ["contiguous", "copy", "new", "strided"])
def test_equal_content_gives_an_equal_key(form, pool):
    """The broadcast's raw key and store digest read content only: the
    array itself, a copy, a new array from its bytes and a strided view
    of equal values give one key and one digest."""
    from fiber_tpu_torch.pool import content_key

    arr = _key_forms()[form]
    assert content_key(arr) == content_key(BCAST)
    assert pool._bcast_store_digest(arr) == pool._bcast_store_digest(BCAST)


@pytest.mark.parametrize("form", ["contiguous", "strided"])
def test_the_store_digest_does_not_depend_on_the_first_layout(form):
    """An empty digest cache's first sight of BCAST's values, contiguous
    or as a strided view, maps their key to the digest of the contiguous
    serialized form, the same whichever layout came first."""
    import types

    from fiber_tpu_torch import serialization
    from fiber_tpu_torch.pool import ResilientPool
    from fiber_tpu_torch.store.core import digest_of

    empty = types.SimpleNamespace(_bcast_digests={})
    got = ResilientPool._bcast_store_digest(empty, _key_forms()[form])
    assert got == digest_of(serialization.dumps(BCAST))


@pytest.mark.parametrize("where", [0, 262_144, 599_999])
def test_an_in_place_change_gives_a_new_key(where, pool):
    """One element changed in place (in the first, second or last chunk)
    gives a new raw key, and the store digest of the new content, not
    the cached digest of the old."""
    from fiber_tpu_torch import serialization
    from fiber_tpu_torch.pool import content_key
    from fiber_tpu_torch.store.core import digest_of

    arr = BCAST.copy()
    key, digest = content_key(arr), pool._bcast_store_digest(arr)
    arr[where] += 1.0
    assert content_key(arr) != key
    assert pool._bcast_store_digest(arr) != digest
    assert pool._bcast_store_digest(arr) == digest_of(
        serialization.dumps(arr))


@pytest.mark.parametrize("size", [1_000, 262_144, 600_000])
def test_the_store_digest_is_the_serialized_forms(size, pool):
    """Below, at and above one chunk, the digest the device tier is keyed
    by is ``digest_of(serialization.dumps(arr))`` (the store space the
    locality seed and every ref live in), the first time and from the
    cache; the raw key is the SHA-256 of the header and of each chunk's
    SHA-256, and differs for the same bytes read as another dtype or
    shape."""
    import hashlib

    from fiber_tpu_torch import serialization
    from fiber_tpu_torch.pool import _KEY_CHUNK, content_key
    from fiber_tpu_torch.store.core import digest_of

    arr = BCAST[:size].copy()
    want = digest_of(serialization.dumps(arr))
    assert pool._bcast_store_digest(arr) == want
    assert pool._bcast_store_digest(arr.copy()) == want
    raw = memoryview(arr).cast("B")
    tree = b"".join(hashlib.sha256(raw[i:i + _KEY_CHUNK]).digest()
                    for i in range(0, len(raw), _KEY_CHUNK))
    head = f"{arr.dtype}|{arr.shape}|{_KEY_CHUNK}|".encode()
    assert content_key(arr) == hashlib.sha256(head + tree).hexdigest()
    assert content_key(arr.view(np.int32)) != content_key(arr)
    assert content_key(arr.reshape(1, -1)) != content_key(arr)
