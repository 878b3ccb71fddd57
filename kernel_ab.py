#!/usr/bin/env python3
"""Times the flash kernels (the forward, dq and dk/dv) of several builds
of their sources in turns, in one process on one NVIDIA card, beside the
library's attention (SDPA).

    python3 kernel_ab.py --tree parent=DIR --tree change=fiber_tpu_torch/csrc \
        [--kernels flash_fwd,flash_bwd_dq,flash_bwd_dkv] [--shapes ...] \
        [--rounds N]

Each ``--tree NAME=DIR`` names a directory of kernel sources
(``flash_fwd.cu``, ``flash_bwd_dq.cu``, ``flash_bwd_dkv.cu`` and the
headers they include), for example this checkout's
``fiber_tpu_torch/csrc`` and the ``csrc`` of a parent commit unpacked
with ``git archive``. ``--kernels`` names the kernels timed (all three
by default). Every tree's libraries of those kernels are built with the
port's nvcc flags (one nvcc a source, all started together), and what
ptxas reports of each template is printed. Then at each shape (a name of
``chip_smoke.MAIN_SHAPES``, causal): inputs from a seed, and for every
tree the forward held against the plain forward within
``chip_smoke.TOL`` and ``LSE_TOL``, and both backward kernels (from this
checkout's forward's O and lse) against the plain backward within
``chip_smoke.BWD_TOL``, each with a second launch equal bit for bit;
then, after an untimed round, each kernel of each tree timed by CUDA
events over ``--rounds`` rounds (4 by default), the trees in order and
then in reverse in every pair of rounds (parent, change, change,
parent), each timing followed by the card's SM clock, temperature and
power draw as NVML reads them then (``card``, beside ``ms``), and the
library's forward and backward timed in the same call with the backend
``torch._fused_sdp_choice`` picks for each. One JSON line a shape, after
the card's name and power limit (``nvidia-smi``) and the build's.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import chip_smoke
from chip_smoke import check, emit

#: the kernels that can be timed, by source name
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
DEFAULT_SHAPES = ("gemma_f32", "gemma_bf16", "gemma_f16", "lm_f32",
                  "attention_bf16", "attention_f16", "llama1b_bf16",
                  "llama1b_f16", "llama8b_bf16", "v4_f16")
#: rounds of timings (every second one in reverse order), and launches a
#: timing after one warm-up
ROUNDS = 4
REPS = 5
#: NVML's codes of the SM clock (nvmlClockType_t) and of the GPU's own
#: temperature sensor (nvmlTemperatureSensors_t)
NVML_CLOCK_SM = 1
NVML_TEMPERATURE_GPU = 0


def card_state_reader():
    """A function that reads the first card's SM clock (MHz),
    temperature (C) and power draw (W) through NVML (``ctypes``, as
    ``fiber_tpu_torch.telemetry.device`` loads it) into a dict."""
    from fiber_tpu_torch.telemetry.device import _load_nvml

    lib = _load_nvml()
    handle = ctypes.c_void_p()
    check(lib.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(handle)) == 0,
          "NVML has no card 0")
    for fn, args in (("nvmlDeviceGetClockInfo", [ctypes.c_int]),
                     ("nvmlDeviceGetTemperature", [ctypes.c_int]),
                     ("nvmlDeviceGetPowerUsage", [])):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, *args,
                                     ctypes.POINTER(ctypes.c_uint)]
        getattr(lib, fn).restype = ctypes.c_int

    def read():
        clock, temp, milliwatts = (ctypes.c_uint() for _ in range(3))
        check(lib.nvmlDeviceGetClockInfo(handle, NVML_CLOCK_SM,
                                         ctypes.byref(clock)) == 0
              and lib.nvmlDeviceGetTemperature(handle, NVML_TEMPERATURE_GPU,
                                               ctypes.byref(temp)) == 0
              and lib.nvmlDeviceGetPowerUsage(handle,
                                              ctypes.byref(milliwatts)) == 0,
              "NVML could not read the card's clock, temperature or power")
        return {"sm_clock_mhz": clock.value, "temperature_c": temp.value,
                "power_w": milliwatts.value / 1000}

    return read


def build_tree(tree, src, out, kernels):
    """The libraries of ``kernels`` of one tree of sources: ``{kernel:
    (library path, ptxas rows)}``, built into ``out``."""
    from fiber_tpu_torch import _build

    out.mkdir(parents=True, exist_ok=True)

    def one(name):
        lib = out / f"{name}.so"
        proc = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
             str(lib), str(src / f"{name}.cu")],
            capture_output=True, text=True)
        (out / f"{name}.log").write_text(proc.stdout + proc.stderr)
        check(proc.returncode == 0,
              f"{tree}: nvcc failed on {name}.cu:\n{proc.stderr[-4000:]}")
        return lib, _build.ptxas_report(name, out)

    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        return dict(zip(kernels, pool.map(one, kernels)))


def _query(lib, fn, *args):
    """A query function of a library, or None where that build has none."""
    try:
        f = getattr(lib, fn)
    except AttributeError:
        return None
    f.argtypes = [ctypes.c_int] * len(args)
    return f(*args)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR of kernel sources; two or more")
    ap.add_argument("--shapes", default=",".join(DEFAULT_SHAPES),
                    help="names of chip_smoke.MAIN_SHAPES")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"the kernels timed, of {','.join(KERNELS)}")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help="rounds of timings, every second one in reverse")
    args = ap.parse_args(argv)
    check(args.rounds >= 1, f"--rounds {args.rounds}: one or more")
    kernels = tuple(k for k in KERNELS if k in args.kernels.split(","))
    check(kernels and len(kernels) == len(args.kernels.split(",")),
          f"--kernels {args.kernels}: name some of {KERNELS}")
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    from fiber_tpu_torch.ops import flash_attention as fa
    from fiber_tpu_torch.utils import flops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trees = dict(t.split("=", 1) for t in args.tree)
    check(len(trees) >= 2, "give two trees or more")
    card = chip_smoke.card_line()
    print(card, flush=True)
    card_state = card_state_reader()
    out_dir = pathlib.Path(tempfile.mkdtemp(prefix="kernel_ab_"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(trees)) as pool:
        built = dict(zip(trees, pool.map(
            lambda item: build_tree(item[0], pathlib.Path(item[1]).resolve(),
                                    out_dir / item[0], kernels),
            trees.items())))
    libs = {tree: {name: (fa.declare_fwd(ctypes.CDLL(str(path)))
                          if name == "flash_fwd" else
                          fa.declare_bwd(ctypes.CDLL(str(path)), name))
                   for name, (path, _) in b.items()}
            for tree, b in built.items()}
    emit({"phase": "build", "build_seconds": time.perf_counter() - t0,
          "ptxas": {tree: {name: rows for name, (_, rows) in b.items()}
                    for tree, b in built.items()}})
    shapes = {m[0]: m for m in chip_smoke.MAIN_SHAPES}
    bwd = [k for k in kernels if k != "flash_fwd"]
    for name in args.shapes.split(","):
        _, s, h, kvh, d, dt, window = shapes[name]
        dtype = getattr(torch, dt)
        kw = dict(causal=True, window=window)
        q, k, v = chip_smoke._inputs(torch, s, h, kvh, d, dtype, seed=7)
        row = {"shape": name, "S": s, "heads": h, "kv_heads": kvh,
               "head_dim": d, "dtype": dt, "window": window, "trees": {}}
        want, bufs = {}, {}
        if "flash_fwd" in kernels:
            want["flash_fwd"] = fa.flash_attention_reference(q, k, v, **kw)
            bufs["flash_fwd"] = (torch.empty_like(q), torch.empty(
                h, s, dtype=torch.float32, device="cuda"))
            n_flops = flops.attention_flops(s, h, d, **kw)
            # q, k and v read once, O and lse written once
            row["flash_fwd_bound_ms"] = flops.bound_ms(
                n_flops, 2 * q.nbytes + k.nbytes + v.nbytes + 4 * h * s,
                dt)[0]
        if bwd:
            o, lse = fa.flash_fwd(q, k, v, **kw)
            g = torch.Generator(device="cuda").manual_seed(8)
            dout = chip_smoke._randn(torch, (s, h, d), dtype, g)
            delta = fa.flash_bwd_delta(o, dout)
            grads = fa.flash_bwd_reference(q, k, v, dout, lse, delta, **kw)
            want.update(flash_bwd_dq=grads[:1], flash_bwd_dkv=grads[1:])
            bufs.update(flash_bwd_dq=(torch.empty_like(q),),
                        flash_bwd_dkv=(torch.empty_like(k),
                                       torch.empty_like(v)))

        def launch(tree, kernel):
            if kernel == "flash_fwd":
                fa._launch_fwd(q, k, v, *bufs[kernel],
                               lib=libs[tree][kernel], **kw)
            else:
                fa._launch_bwd(kernel, bufs[kernel], q, k, v, dout, lse,
                               delta, lib=libs[tree][kernel], **kw)

        for tree in trees:
            entry = {}
            if "flash_bwd_dkv" in kernels:
                entry["dkv_parts"] = _query(libs[tree]["flash_bwd_dkv"],
                                            "flash_bwd_dkv_parts", s, kvh,
                                            h // kvh, d)
            for kernel in kernels:
                launch(tree, kernel)
                first = [x.clone() for x in bufs[kernel]]
                launch(tree, kernel)
                torch.cuda.synchronize()
                if kernel == "flash_fwd":
                    ro, rlse = want[kernel]
                    err = (first[0].float() - ro.float()).abs().max().item()
                    lse_err = (first[1] - rlse).abs().max().item()
                    check(err < chip_smoke.TOL[dt]
                          and lse_err < chip_smoke.LSE_TOL,
                          f"{tree} {kernel} at {name}: err {err}, lse err "
                          f"{lse_err}")
                    entry[kernel] = {"max_abs_err": err, "lse_err": lse_err,
                                     "ms": [], "card": []}
                else:
                    _, rel = chip_smoke._bwd_errors(first, want[kernel])
                    check(rel < chip_smoke.BWD_TOL[dt],
                          f"{tree} {kernel} at {name}: rel err {rel}")
                    entry[kernel] = {"rel_err": rel, "ms": [], "card": []}
                check(all(torch.equal(chip_smoke._bits(torch, a),
                                      chip_smoke._bits(torch, b))
                          for a, b in zip(first, bufs[kernel])),
                      f"{tree} {kernel} at {name}: two launches differ")
            row["trees"][tree] = entry
        order = list(trees)
        # an untimed round first: the card's clocks rise after the idle
        # build (the first two timed rounds ran up to 25% slow without it)
        for tree in order:
            for kernel in kernels:
                chip_smoke.cuda_ms(torch, lambda: launch(tree, kernel),
                                   reps=REPS)
        for r in range(args.rounds):
            for tree in (order if r % 2 == 0 else order[::-1]):
                for kernel in kernels:
                    timed = row["trees"][tree][kernel]
                    timed["ms"].append(chip_smoke.cuda_ms(
                        torch, lambda: launch(tree, kernel), reps=REPS))
                    timed["card"].append(card_state())
        for entry in row["trees"].values():
            for kernel in kernels:
                times = entry[kernel]["ms"]
                entry[kernel]["mean_ms"] = sum(times) / len(times)
            if bwd:
                entry["pair_ms"] = sum(entry[k]["mean_ms"] for k in bwd)
        if "flash_fwd" in kernels:
            row["library_fwd_ms"] = chip_smoke.cuda_ms(
                torch, chip_smoke._sdpa(torch, q, k, v, window), reps=10)
            row["library_fwd_backend"] = chip_smoke._sdpa_backend(
                torch, q, k, v, window)
        if bwd:
            row["library_ms"] = chip_smoke.cuda_ms(
                torch, chip_smoke._sdpa_bwd(torch, q, k, v, dout, window),
                reps=3)
            row["library_backend"] = chip_smoke._sdpa_backend(
                torch, q, k, v, window, grad=True)
        emit(row)
        del q, k, v, want, bufs
        if bwd:
            del o, lse, dout, delta, grads
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
