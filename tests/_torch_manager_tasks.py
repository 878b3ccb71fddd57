"""Targets that the port's manager tests run in
``fiber_tpu_torch.Process`` children, and the class they register on an
``AsyncManager``. Module level, so that children import them by
reference; the module imports neither JAX nor the JAX package."""

from __future__ import annotations

import time


def list_appender(proxy, n):
    """Mutates a managed list from another process."""
    for i in range(n):
        proxy.append(i)


def queue_consumer(qproxy, out_q, n):
    out_q.put(sum(qproxy.get() for _ in range(n)))


def tensor_writer(dproxy, key, seed):
    """Puts a tensor made in this process into a managed dict."""
    import torch

    dproxy[key] = torch.randn(4, 3, generator=torch.Generator().manual_seed(
        seed))


def locked_increment(lock, ns, n):
    """Read-modify-write under a managed lock."""
    for _ in range(n):
        with lock:
            ns.counter = ns.counter + 1


def barrier_then_report(barrier, q, tag):
    barrier.wait()
    q.put(tag)


def condition_consumer(cond, ns, out_q):
    with cond:
        while not ns.ready:
            cond.wait(30)
    out_q.put("saw ready")


class SlowWorker:
    """A user class registered on an AsyncManager (RL-env style)."""

    def step(self, x):
        time.sleep(1.0)
        return x + 100
