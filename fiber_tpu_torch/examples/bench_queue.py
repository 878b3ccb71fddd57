"""Queue micro-benchmark: msgs/sec + effective Mbps through a SimpleQueue
between two processes (reference: examples/bench_queue.py).

Run:  python -m fiber_tpu_torch.examples.bench_queue [--msgs 20000] [--size 1024]

The JAX package's ``examples/bench_queue.py`` with the package renamed
(``tests/test_torch_examples.py`` holds it to the original); it
runs on the host only.
"""


import argparse
import sys
import time


def echo_worker(q_in, q_out, n):
    for _ in range(n):
        q_out.put(q_in.get())


def drain_worker(q_in, q_done, n):
    """One-way consumer: drain n messages, then report completion."""
    for _ in range(n):
        q_in.get()
    q_done.put("done")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--msgs", type=int, default=20_000)
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--prefetch", type=int, default=1,
                        help="consumer credit window (1 = pure "
                             "demand-driven; N pipelines N messages)")
    parser.add_argument("--stream", action="store_true",
                        help="one-way streaming throughput instead of "
                             "round-trips (round-trips measure latency; "
                             "this measures the pipe's actual rate)")
    args = parser.parse_args()

    import fiber_tpu_torch

    if args.stream:
        q_in = fiber_tpu_torch.SimpleQueue(prefetch=args.prefetch)
        q_done = fiber_tpu_torch.SimpleQueue()
        p = fiber_tpu_torch.Process(target=drain_worker,
                              args=(q_in, q_done, args.msgs))
        p.start()
        payload = b"x" * args.size
        t0 = time.time()
        for _ in range(args.msgs):
            q_in.put(payload)
        assert q_done.get(60) == "done"
        elapsed = time.time() - t0
        p.join(30)
        rate = args.msgs / elapsed
        mbps = rate * args.size * 8 / 1e6
        print(f"{args.msgs} one-way msgs of {args.size}B in "
              f"{elapsed:.2f}s: {rate:,.0f} msgs/s, {mbps:,.1f} Mbps")
        q_in.close()
        q_done.close()
        return 0

    q_in, q_out = fiber_tpu_torch.SimpleQueue(), fiber_tpu_torch.SimpleQueue()
    p = fiber_tpu_torch.Process(target=echo_worker,
                          args=(q_in, q_out, args.msgs))
    p.start()

    payload = b"x" * args.size
    t0 = time.time()
    inflight = 0
    sent = received = 0
    while received < args.msgs:
        while sent < args.msgs and inflight < 512:
            q_in.put(payload)
            sent += 1
            inflight += 1
        q_out.get()
        received += 1
        inflight -= 1
    elapsed = time.time() - t0
    p.join(30)

    rate = args.msgs / elapsed
    mbps = rate * args.size * 8 / 1e6
    print(f"{args.msgs} round-trips of {args.size}B in {elapsed:.2f}s: "
          f"{rate:,.0f} msgs/s, {mbps:,.1f} Mbps effective")
    q_in.close()
    q_out.close()


if __name__ == "__main__":
    sys.exit(main())
