"""Data-parallel SGD over a Ring — the reference's examples/ring.py
without torch.distributed: gradients are averaged with the port's own
host ring allreduce (``HostRing``), and the ranks import no torch.

Counterpart of the JAX package's ``examples/ring_allreduce.py``.

Run:  python -m fiber_tpu_torch.examples.ring_allreduce [--size 2]
"""

import argparse
import sys


def sgd_rank(rank, size):
    import numpy as np

    from fiber_tpu_torch.parallel.ring import current_ring

    ring = current_ring()
    rng = np.random.default_rng(rank)
    # toy least squares: y = Xw*, each rank holds a shard of the data
    true_w = np.arange(8, dtype=np.float32)
    X = rng.normal(size=(256, 8)).astype(np.float32)
    y = X @ true_w
    w = np.zeros(8, dtype=np.float32)
    for step in range(60):
        grad = 2.0 * X.T @ (X @ w - y) / len(X)
        grad = ring.allreduce(grad, op="mean")   # <- the collective
        w -= 0.05 * grad
    err = float(np.linalg.norm(w - true_w))
    print(f"rank {rank}/{size}: ||w - w*|| = {err:.4f}")
    if err >= 0.05:
        raise RuntimeError(f"rank {rank} did not converge: {err}")
    ring.close()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=2)
    args = parser.parse_args()

    from fiber_tpu_torch.parallel import Ring

    Ring(args.size, sgd_rank).run()
    print("all ranks converged")


if __name__ == "__main__":
    sys.exit(main())
