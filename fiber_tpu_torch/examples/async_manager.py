"""Async manager demo: N slow environment servers stepped in parallel
(reference: examples/async_manager.py — the docs report 3.72s sync vs
1.68s async for 4 envs).

Run:  python -m fiber_tpu_torch.examples.async_manager [--envs 4]

The JAX package's ``examples/async_manager.py`` with the package renamed
(``tests/test_torch_examples.py`` holds it to the original); it
runs on the host only.
"""


import argparse
import sys
import time


class SlowEnv:
    """Stands in for a CartPole env whose step costs ~50 ms."""

    def __init__(self):
        self.t = 0

    def step(self, action):
        time.sleep(0.05)
        self.t += 1
        return self.t, float(action) * 0.1


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--envs", type=int, default=4)
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args()

    from fiber_tpu_torch.managers import (
        AsyncBaseProxy,
        AsyncManager,
        MakeProxyType,
        SyncManager,
    )

    SyncManager.register("SlowEnv", SlowEnv,
                         MakeProxyType("SlowEnvProxy", ("step",)))
    AsyncManager.register(
        "SlowEnv", SlowEnv,
        MakeProxyType("AsyncSlowEnvProxy", ("step",), base=AsyncBaseProxy),
    )

    sync = SyncManager()
    sync.start()
    envs = [sync.SlowEnv() for _ in range(args.envs)]
    t0 = time.time()
    for _ in range(args.steps):
        for env in envs:
            env.step(1)
    sync_s = time.time() - t0
    sync.shutdown()

    amgr = AsyncManager()
    amgr.start()
    envs = [amgr.SlowEnv() for _ in range(args.envs)]
    t0 = time.time()
    for _ in range(args.steps):
        futures = [env.step(1) for env in envs]
        for fut in futures:
            fut.get(30)
    async_s = time.time() - t0
    amgr.shutdown()

    print(f"{args.envs} envs x {args.steps} steps: "
          f"sync {sync_s:.2f}s vs async {async_s:.2f}s "
          f"({sync_s / async_s:.2f}x speedup)")


if __name__ == "__main__":
    sys.exit(main())
