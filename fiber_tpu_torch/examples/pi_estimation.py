"""Monte-Carlo pi estimation with ``Pool.map``: the reference's
hello-world workload, plus the variant that runs on the card.

Counterpart of the JAX package's ``examples/pi_estimation.py``, with its
flags and its output line. The JAX switch ``--device`` (run the
jittable variant on the device mesh) is ``--device-map`` here, since
``--device`` names the device, as in every program of the port. With
``--device-map`` the map of a ``@meta(device=True)`` function goes
through the pool's device route (no worker; one vmapped call over the
seeds on the card). Each item draws its points from a counter-based
hash of its seed, since a ``torch.Generator`` cannot be seeded per item
under ``torch.func.vmap``; without it, host workers count with Python's
``random``.

Run:  python -m fiber_tpu_torch.examples.pi_estimation [--device-map]
          [--device cpu]
"""

import argparse
import random
import sys
import time

_MASK = 0xFFFFFFFF


def inside(n):
    count = 0
    for _ in range(n):
        x, y = random.random(), random.random()
        if x * x + y * y <= 1.0:
            count += 1
    return count


def hash_uniform(seed, n: int):
    """(n, 2) f32 uniforms in [0, 1) from integer ``seed`` (a 0-d
    tensor), by a 32-bit integer hash of (seed, counter) in int64
    arithmetic: every product stays below 2**63. Vmappable: no
    generator, no in-place write."""
    import torch

    idx = torch.arange(2 * n, device=seed.device, dtype=torch.int64)
    x = (idx * 0x9E3779B1 + seed.long() * 0x7FEB352D + 0x165667B1) & _MASK
    for mult in (0x7FEB352D, 0x2C1B3C6D):
        x = x ^ (x >> 16)
        x = (x * mult) & _MASK
    x = x ^ (x >> 15)
    return ((x >> 8).float() * 2.0 ** -24).reshape(n, 2)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m fiber_tpu_torch.examples.pi_estimation")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--samples", type=int, default=200_000)
    parser.add_argument("--device-map", action="store_true",
                        help="run the tensor variant on the device")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import fiber_tpu_torch
    from fiber_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if args.device_map:
        import numpy as np
        import torch

        @fiber_tpu_torch.meta(device=True)
        def inside_dev(seed):
            pts = hash_uniform(seed, args.samples)
            return (pts[:, 0] ** 2 + pts[:, 1] ** 2 <= 1.0).sum().to(
                torch.float32)

        with fiber_tpu_torch.Pool(args.workers, device=dev) as pool:
            t0 = time.time()
            counts = pool.map(inside_dev, np.arange(args.workers * 4))
            elapsed = time.time() - t0
        total = float(sum(counts))
        n = args.samples * args.workers * 4
    else:
        chunks = [args.samples // args.workers] * args.workers
        with fiber_tpu_torch.Pool(args.workers) as pool:
            t0 = time.time()
            counts = pool.map(inside, chunks)
            elapsed = time.time() - t0
        total = sum(counts)
        n = sum(chunks)

    print(f"pi ~= {4.0 * total / n:.6f}  ({n} samples, {elapsed:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
