"""Parzen-window density estimation with a hyperparameter search over
the pool: evaluate many window widths in parallel and pick the best by
leave-one-out log-likelihood (the reference's second classic demo).

Counterpart of the JAX package's ``examples/parzen_estimation.py``, with
its flags and its output lines. The JAX switch ``--device`` is
``--device-map`` here, since ``--device`` names the device, as in every
program of the port. With ``--device-map`` each width's likelihood is a
``@meta(device=True)`` function that the pool maps on the card (no
worker; one vmapped call over the widths); without it, host workers
evaluate the numpy loop.

Run:  python -m fiber_tpu_torch.examples.parzen_estimation
          [--device-map] [--device cpu]
"""

import argparse
import math
import sys
import time

import numpy as np


def parzen_loglik(args):
    """Leave-one-out log-likelihood of a gaussian Parzen window."""
    h, data = args
    n = len(data)
    total = 0.0
    for i in range(n):
        diff = np.delete(data, i) - data[i]
        kernel = np.exp(-0.5 * (diff / h) ** 2) / (h * np.sqrt(2 * np.pi))
        total += np.log(kernel.mean() + 1e-12)
    return total / n


def loglik_tensor(data, h):
    """:func:`parzen_loglik` of width ``h`` (a 0-d tensor) over ``data``
    (n,) in tensor arithmetic: the whole (n, n) kernel at once, its
    diagonal zeroed for leave-one-out."""
    import torch

    n = data.shape[0]
    diff = data[None, :] - data[:, None]
    k = torch.exp(-0.5 * (diff / h) ** 2) / (h * math.sqrt(2 * math.pi))
    k = k * (1 - torch.eye(n, device=data.device))
    dens = k.sum(dim=1) / (n - 1)
    return torch.log(dens + 1e-12).mean()


def make_data(samples: int):
    """Two gaussians, ``samples`` points in all (f32), from seed 0."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.normal(-2.0, 0.6, samples // 2),
        rng.normal(1.5, 1.0, samples // 2),
    ]).astype(np.float32)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m fiber_tpu_torch.examples.parzen_estimation")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--samples", type=int, default=400)
    parser.add_argument("--widths", type=int, default=24)
    parser.add_argument("--device-map", action="store_true",
                        help="run the tensor variant on the device")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if args.widths < 1:
        parser.error("--widths must be >= 1")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    import fiber_tpu_torch
    from fiber_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    data = make_data(args.samples)
    widths = np.logspace(-2, 0.7, args.widths).astype(np.float32)

    if args.device_map:
        import torch

        data_t = torch.from_numpy(data).to(dev)

        @fiber_tpu_torch.meta(device=True)
        def loglik_dev(h):
            return loglik_tensor(data_t, h)

        with fiber_tpu_torch.Pool(args.workers, device=dev) as pool:
            t0 = time.time()
            scores = pool.map(loglik_dev, widths)
            elapsed = time.time() - t0
        scores = [float(s) for s in scores]
    else:
        with fiber_tpu_torch.Pool(args.workers) as pool:
            t0 = time.time()
            scores = pool.map(
                parzen_loglik, [(float(h), data) for h in widths]
            )
            elapsed = time.time() - t0

    best = int(np.argmax(scores))
    print(f"evaluated {len(widths)} window widths in {elapsed:.2f}s")
    print(f"best h = {widths[best]:.4f}  (loglik {scores[best]:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
