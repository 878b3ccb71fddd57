#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port (``fiber_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel from ``fiber_tpu_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card, drives
the port's main paths at full width (the TinyLM flash forward and greedy
decoding; the OpenAI-ES CartPole flagship) and checks what comes out.
Phases print one JSON line each (build, kernels, lm_forward,
lm_generate, es); then the card's name and power limit as nvidia-smi
reports them, the kernel summary line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is not 0 and no result line is printed; so does a machine without
CUDA, or a directory that holds this script without the package.

f32 products of the plain versions run in full f32 (TF32 is switched
off), so kernel and plain version differ only in summation order.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# (name, S, heads, kv_heads, head_dim, dtype name, window): the LM's
# attention at full width (TinyLM dim 256 / 8 heads at the repo's
# default --seq 16384), its GQA and sliding-window variants
# (bench.py's window leg uses 1024), and bench.py --attention's shape.
MAIN_SHAPES = (
    ("lm_f32", 16384, 8, 8, 32, "float32", None),
    ("lm_f32_gqa", 16384, 8, 2, 32, "float32", None),
    ("lm_f32_window", 16384, 8, 8, 32, "float32", 1024),
    ("attention_bf16", 16384, 8, 8, 64, "bfloat16", None),
)
# Small shapes for the kernel's edges: ragged tiles, every head-dim
# template, non-causal, windows shorter than a tile.
EDGE_SHAPES = (
    ("edge_noncausal_d8", 100, 4, 2, 8, "float32", None, False),
    ("edge_d40_ragged", 77, 2, 2, 40, "float32", None, True),
    ("edge_d128_window", 1000, 3, 1, 128, "bfloat16", 100, True),
    ("edge_d16_window1", 130, 2, 1, 16, "float32", 1, True),
)
# Output tolerance by dtype: f32 results differ by summation order only;
# bf16 outputs may round to neighbouring bf16 values (one ulp at |o| ~ 4).
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
LSE_TOL = 1e-4
LM_CFG = dict(vocab=256, dim=256, heads=8, layers=4, max_seq=16384)
LM_TOL = 1e-4   # f32 logits of two attention engines, four layers
FLASH_SOURCE = "fiber_tpu_torch/csrc/flash_fwd.cu"
FLASH_REPLACES = "fiber_tpu/ops/pallas_attention.py:68"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps, warmup=1):
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls,
    by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = out.stdout.strip().splitlines()[0].strip()
    check(line, "nvidia-smi printed no card")
    return line


def phase_build():
    from fiber_tpu_torch import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    check("flash_fwd" in libs, "flash_fwd.cu was not built")
    emit({"phase": "build", "seconds": secs,
          "libraries": {k: v.name for k, v in libs.items()},
          "ptxas": {k: _build.compiler_report(k) for k in libs}})


def _inputs(torch, s, h, kvh, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(s, n, d, generator=g, device="cuda").to(dtype)
                 for n in (h, kvh, kvh))


def _sdpa(torch, q, k, v, window):
    """The library's attention on the same inputs, for timing only."""
    F = torch.nn.functional
    qt, kt, vt = (x.permute(1, 0, 2).unsqueeze(0) for x in (q, k, v))
    gqa = k.shape[1] != q.shape[1]
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=gqa)
    s = q.shape[0]
    pos = torch.arange(s, device="cuda")
    diff = pos[:, None] - pos[None, :]
    mask = (diff >= 0) & (diff < window)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=gqa)


def phase_kernels(torch, card):
    from fiber_tpu_torch.ops import flash_attention as fa
    from fiber_tpu_torch.utils import flops

    rows = []
    for name, s, h, kvh, d, dt, window, causal in EDGE_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = _inputs(torch, s, h, kvh, d, dtype, seed=len(rows))
        o, lse = fa.flash_fwd(q, k, v, causal=causal, window=window)
        ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal,
                                                window=window)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        check(err < TOL[dt] and lse_err < LSE_TOL,
              f"{name}: max_abs_err {err} lse_err {lse_err}")
        rows.append({"shape": name, "max_abs_err": err, "lse_err": lse_err,
                     "tol": TOL[dt]})

    main = {}
    for name, s, h, kvh, d, dt, window in MAIN_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = _inputs(torch, s, h, kvh, d, dtype, seed=len(rows))
        o, lse = fa.flash_fwd(q, k, v, causal=True, window=window)
        ro, rlse = fa.flash_attention_reference(q, k, v, causal=True,
                                                window=window)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        check(bool(torch.isfinite(o.float()).all()), f"{name}: non-finite")
        check(err < TOL[dt] and lse_err < LSE_TOL,
              f"{name}: max_abs_err {err} lse_err {lse_err}")
        del ro, rlse
        ms = cuda_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True,
                                                 window=window), reps=10)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_reference(
            q, k, v, causal=True, window=window), reps=3)
        library_ms = cuda_ms(torch, _sdpa(torch, q, k, v, window), reps=5)
        n_flops = flops.attention_flops(s, h, d, causal=True, window=window)
        nbytes = (q.nbytes + k.nbytes + v.nbytes + o.nbytes + lse.nbytes)
        bound, bound_by = flops.bound_ms(n_flops, nbytes, dt)
        row = {"shape": name, "S": s, "heads": h, "kv_heads": kvh,
               "head_dim": d, "dtype": dt, "window": window,
               "max_abs_err": err, "lse_err": lse_err, "tol": TOL[dt],
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound, "bound_by": bound_by,
               "peak_flops": flops.H100_PEAK_FLOPS[dt],
               "tflops": n_flops / ms / 1e9}
        rows.append(row)
        main[name] = row
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "card": card, "flash_fwd_launches":
          fa.flash_fwd.launches, "shapes": rows})
    return main


def _lm_models(torch):
    from fiber_tpu_torch.models import convert
    from fiber_tpu_torch.models.transformer import TinyLM

    state = convert.tinylm_params_from_jax(
        convert.random_tinylm_tree(**LM_CFG, seed=0), device="cuda")
    models = {}
    for attention in ("flash", "reference"):
        m = TinyLM(**LM_CFG, attention=attention, device="cuda")
        m.load_state_dict(state)
        models[attention] = m
    return models


def phase_lm_forward(torch, models):
    from fiber_tpu_torch.ops import flash_attention as fa
    from fiber_tpu_torch.utils import flops

    model = models["flash"]
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, LM_CFG["vocab"], (LM_CFG["max_seq"],),
                           generator=g, device="cuda")
    model.apply(tokens)                       # warm-up, not counted
    torch.cuda.synchronize()

    fa.flash_fwd.launches = 0
    t0 = time.perf_counter()
    logits = model.apply(tokens)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fa.flash_fwd.launches

    check(launches == LM_CFG["layers"],
          f"flash_fwd launched {launches} times, want {LM_CFG['layers']}")
    check(tuple(logits.shape) == (LM_CFG["max_seq"], LM_CFG["vocab"]),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    ref = models["reference"].apply(tokens)
    err = (logits - ref).abs().max().item()
    check(err < LM_TOL, f"flash vs reference logits differ by {err}")
    n_flops = flops.tinylm_flops_per_step(model, LM_CFG["max_seq"],
                                          train=False)
    emit({"phase": "lm_forward", **LM_CFG, "attention": "flash",
          "flash_fwd_launches": launches, "seconds": secs,
          "tokens_per_s": LM_CFG["max_seq"] / secs,
          "tflops": n_flops / secs / 1e12,
          "max_abs_err_vs_reference": err, "tol": LM_TOL})
    return launches, tokens, logits


def phase_lm_generate(torch, models, tokens, logits):
    model = models["flash"]
    n_prompt, steps = 32, 32
    # Incremental decoding reproduces the flash forward's logits.
    caches = model.new_caches()
    err = 0.0
    for pos in range(n_prompt):
        step = model._decode_step(caches, pos, tokens[pos])
        err = max(err, (step - logits[pos]).abs().max().item())
    check(err < LM_TOL, f"decode vs forward logits differ by {err}")

    prompt = tokens[:n_prompt]
    model.generate(prompt, 2)                 # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(prompt, steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(tuple(out.shape) == (n_prompt + steps,), f"shape {out.shape}")
    check(bool(torch.equal(out[:n_prompt], prompt)), "prompt not kept")
    check(bool(((out >= 0) & (out < LM_CFG["vocab"])).all()),
          "token out of range")
    emit({"phase": "lm_generate", "prompt": n_prompt, "steps": steps,
          "seconds": secs, "tokens_per_s": steps / secs,
          "decode_max_abs_err_vs_forward": err, "tol": LM_TOL})


def phase_es(torch):
    from fiber_tpu_torch.entry import entry, flagship_policy, run_es
    from fiber_tpu_torch.models.envs import CartPole

    pop, steps, gens = 4096, 500, 3
    # The card against the CPU on one small batch, same inputs: returns
    # agree unless sin/cos of two libraries tip an episode's last step.
    fn, (params, states) = entry(device="cuda", pop=256, max_steps=200)
    policy = flagship_policy()
    g = torch.Generator().manual_seed(2)
    thetas = params + 0.3 * torch.randn(params.shape, generator=g).cuda()
    on_card = fn(thetas, states).cpu()
    on_cpu = CartPole.rollout(policy.act, thetas.cpu(), states.cpu(),
                              max_steps=200)
    same = (on_card == on_cpu).float().mean().item()
    check(same >= 0.95, f"only {same:.3f} of CPU returns reproduced")

    fn, args = entry(device="cuda", pop=pop, max_steps=steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = fn(*args)
    torch.cuda.synchronize()
    eval_secs = time.perf_counter() - t0
    check(tuple(fit.shape) == (pop,), f"fitness shape {tuple(fit.shape)}")
    check(bool(((fit >= 1) & (fit <= steps)).all()), "returns out of range")

    t0 = time.perf_counter()
    new_params, stats = run_es(device="cuda", pop=pop, max_steps=steps,
                               generations=gens)
    torch.cuda.synchronize()
    es_secs = time.perf_counter() - t0
    check(bool(torch.isfinite(stats).all()), f"stats {stats.tolist()}")
    check(bool(torch.isfinite(new_params).all()), "non-finite params")
    emit({"phase": "es", "pop": pop, "max_steps": steps, "hidden": [32, 32],
          "sigma": 0.1, "lr": 0.03, "card_vs_cpu_same_returns": same,
          "eval_seconds": eval_secs, "eval_evals_per_s": pop / eval_secs,
          "generations": gens, "es_seconds": es_secs,
          "es_evals_per_s": gens * pop / es_secs,
          "stats": stats.tolist()})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    phase_build()
    main_rows = phase_kernels(torch, card)
    models = _lm_models(torch)
    launches, tokens, logits = phase_lm_forward(torch, models)
    phase_lm_generate(torch, models, tokens, logits)
    del models, tokens, logits
    torch.cuda.empty_cache()
    phase_es(torch)

    lm = main_rows["lm_f32"]
    print(card, flush=True)
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": launches,
        "max_abs_err": lm["max_abs_err"], "ms": lm["ms"],
        "plain_ms": lm["plain_ms"], "bound_ms": lm["bound_ms"],
        "bound_by": lm["bound_by"], "library_ms": lm["library_ms"]}]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
