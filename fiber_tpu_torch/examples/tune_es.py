"""Sweep ES population sizes on the card and report the best operating
point (evals/s rises with the population until the card saturates).

Counterpart of the JAX package's ``examples/tune_es.py``, with its
flags, its lines and its JSON record; the JAX ``--platform`` is
``--device`` here. For each population, a first ``run_fused`` of
``--gens`` generations, which captures the generation's CUDA graph, is
timed as "compile", and a second one, which only replays it, as
"steady". Each row also carries the card's peak memory over the two
runs (``torch.cuda.max_memory_allocated``; None on the CPU).

Run:  python -m fiber_tpu_torch.examples.tune_es
          [--pops 2048,4096,8192,16384] [--steps 500] [--gens 5]
          [--json OUT.json] [--device cpu]
"""

import argparse
import json
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m fiber_tpu_torch.examples.tune_es")
    parser.add_argument("--pops", default="2048,4096,8192,16384")
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--gens", type=int, default=5)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--json", default="")
    return parser.parse_args(argv)


def sweep(pops, steps: int, gens: int, device=None) -> dict:
    """The sweep's record: one row a population, the best of them."""
    import torch

    from fiber_tpu_torch.device import resolve_device
    from fiber_tpu_torch.entry import flagship_es, fused_twice
    from fiber_tpu_torch.parallel.mesh import default_mesh

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    mesh = default_mesh(dev)
    rows = []
    for pop in pops:
        es, params = flagship_es(mesh, pop, steps)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        params, stats, compile_s, dt = fused_twice(es, params, gens)
        evals_s = es.pop_size * gens / dt
        rows.append({
            "pop": es.pop_size,
            "evals_per_sec": round(evals_s, 1),
            "env_steps_per_sec": round(evals_s * steps, 1),
            "steady_s": round(dt, 3),
            "compile_s": round(compile_s, 1),
            "peak_bytes": (torch.cuda.max_memory_allocated(dev) if cuda
                           else None),
        })
        print(f"pop={es.pop_size:6d}  {evals_s:10.1f} evals/s  "
              f"(steady {dt:.3f}s, compile {compile_s:.1f}s)", flush=True)
        del es, params, stats
    best = max(rows, key=lambda r: r["evals_per_sec"])
    return {
        "platform": "gpu" if cuda else dev.type,
        "n_devices": mesh.n_dev,
        "episode_steps": steps,
        "generations": gens,
        "rows": rows,
        "best_pop": best["pop"],
        "best_evals_per_sec": best["evals_per_sec"],
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    out = sweep([int(p) for p in args.pops.split(",")], args.steps,
                args.gens, args.device)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
