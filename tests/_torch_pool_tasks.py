"""Task functions that the port's pool tests ship to worker processes of
both packages' pools. Module level, so that workers import them by
reference; the module imports neither JAX nor either package, and torch
only inside the tensor tasks, so that a worker's ``sys.modules`` shows
what the pool itself brought in."""

from __future__ import annotations

import os
import signal
import sys


def square(x):
    return x * x


def add(a, b):
    return a + b


def raise_on_even(x):
    if x % 2 == 0:
        raise ValueError(f"even input {x}")
    return x


def row_stats(row):
    """A numpy row in, a small tuple of numpy values out."""
    return row.sum(), row.max(), row * 2


def die_once(marker, x):
    """Kills its worker with SIGKILL the first time it sees x == 7 (the
    marker file records that it did); otherwise returns x."""
    if x == 7 and not os.path.exists(marker):
        with open(marker, "w") as fh:
            fh.write("died")
        os.kill(os.getpid(), signal.SIGKILL)
    return x


def loaded_modules(_):
    """Which of JAX, torch and the JAX package this worker has loaded."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "jaxlib", "torch", "fiber_tpu")
                  or m.startswith("fiber_tpu."))


def tensor_affine(t, k):
    """A tensor in, a tensor out on the same device, with the device type
    the worker saw."""
    return t * 2 + k, t.device.type


def tensor_roundtrip(t):
    """The worker's view of a tensor argument and a tensor result made
    from it."""
    return {"sum": float(t.double().sum()), "dtype": str(t.dtype),
            "shape": tuple(t.shape), "requires_grad": t.requires_grad,
            "back": t.detach() + 1}


def sleep_echo(x):
    """Returns x after 50 ms: paces a map so that a kill lands mid-map."""
    import time

    time.sleep(0.05)
    return x


def sleep_tensors(x):
    """After 50 ms, two CPU tensors made from x, of two dtypes."""
    import time

    import torch

    time.sleep(0.05)
    return (torch.arange(4, dtype=torch.float64) / 3 + x,
            torch.tensor([x, -x], dtype=torch.int32))


def cartpole_fitness(seed, device="cuda", pop=256, steps=200):
    """Fitness of ``pop`` CartPole MLP policies (the flagship MLP, its
    parameters perturbed around a seeded draw) over up to ``steps``
    steps, on ``device``: an ES generation's unit of work, returned as
    a tensor on that device."""
    import torch

    from fiber_tpu_torch.entry import flagship_policy
    from fiber_tpu_torch.models.envs import CartPole

    policy = flagship_policy()
    g = torch.Generator(device=device).manual_seed(int(seed))
    params = policy.init(torch.Generator().manual_seed(int(seed)),
                         device=device)
    thetas = params + 0.1 * torch.randn(pop, policy.dim, generator=g,
                                        device=device)
    states = CartPole.reset(pop, g)
    with torch.no_grad():
        return CartPole.rollout(policy.act, thetas, states,
                                max_steps=steps)
