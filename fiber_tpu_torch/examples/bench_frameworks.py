"""Framework-overhead benchmark: Pool throughput on fixed-duration tasks
versus stdlib multiprocessing (reference: examples/bench_frameworks.py —
the headline comparison in the reference docs: near-parity with
multiprocessing at 1 ms / 10 ms / 100 ms task durations).

Run:  python -m fiber_tpu_torch.examples.bench_frameworks [--workers 5]

The JAX package's ``examples/bench_frameworks.py`` with the package renamed
(``tests/test_torch_examples.py`` holds it to the original); it
runs on the host only.
"""


import argparse
import sys
import time


def timed_task(duration):
    time.sleep(duration)
    return duration


def bench_pool(make_pool, n_tasks, duration, workers):
    with make_pool(workers) as pool:
        # warmup: make sure all workers are up so steady-state throughput
        # is measured (mp's map implicitly waits for its eager workers)
        pool.map(timed_task, [0.0] * workers)
        if hasattr(pool, "wait_workers"):
            pool.wait_workers(timeout=60)
        t0 = time.time()
        pool.map(timed_task, [duration] * n_tasks)
        return time.time() - t0


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--workers", type=int, default=5)
    args = parser.parse_args()

    import multiprocessing

    import fiber_tpu_torch

    print(f"{'duration':>10} {'tasks':>7} {'ideal':>8} "
          f"{'fiber_tpu_torch':>10} {'mp':>8} {'overhead_vs_mp':>14}")
    for duration, n_tasks in ((0.1, 50), (0.01, 500), (0.001, 1000)):
        ideal = duration * n_tasks / args.workers
        fib = bench_pool(
            lambda w: fiber_tpu_torch.Pool(w), n_tasks, duration, args.workers
        )
        mp = bench_pool(
            lambda w: multiprocessing.get_context("spawn").Pool(w),
            n_tasks, duration, args.workers,
        )
        print(f"{duration * 1000:>8.0f}ms {n_tasks:>7} {ideal:>7.2f}s "
              f"{fib:>9.2f}s {mp:>7.2f}s {fib / mp:>13.2f}x")


if __name__ == "__main__":
    sys.exit(main())
