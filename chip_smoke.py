#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port (``fiber_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel from ``fiber_tpu_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card (and
counts the tensor-core instructions in the SASS of the three flash
kernels), drives the port's main paths at full width (the TinyLM flash
forward, greedy decoding and training; the OpenAI-ES CartPole flagship,
eager and as CUDA-graph replays; ring and Ulysses attention, the TinyLM
forward and TinyLM training over a 4-rank mesh on the card; the ES step
over that mesh; the population-search families: PGPE, SepCMAES and CMAES
on CartPole, eager and replayed, NoveltyES and MAP-Elites on the
deceptive maze, AskTellES with a host evaluator, device_map, POET on
ParamCartPole on one rank and over 4, runs resumed from checkpoint
files, and ES on the biped and the pixel chase; ring and Ulysses
attention on a 2 x 2 data x sequence grid; the user API: a
``@meta(device=True)`` map through ``Pool`` and host workers passing
CUDA tensors; a managed dict holding a CUDA tensor, a ``Ring``'s
``HostRing`` allreduce of CUDA tensors, the ES across ``Ring`` processes
joined over gloo, and POET with its ES steps farmed out to ``Pool``
workers; the rest of the host plane: ``run_fused`` captures beside a
durable map of CUDA results, a durable map's master SIGKILLed and
finished by ``python -m fiber_tpu_torch.cli resume``, hierarchical
dispatch, a ``sim:2`` cluster with the CLI's views of its agents,
``Pool.trace_dump`` of a profiled map and ``flash_fwd`` call, and the
serve daemon) and checks what comes out;
the ES, POET and env lines carry model FLOP/s and MFU, and the es
phase writes one generation's profiler trace under TRACE_DIR. Phases
print one JSON line each (build, kernels, kernels_bwd, kernels_ring,
lm_forward, lm_generate, lm_train, es, ring_attention, mesh_2d,
lm_mesh, lm_mesh_train, es_mesh, es_families, es_families_smooth,
novelty, map_elites, ask_tell, device_map, poet, poet_mesh,
checkpoint, es_envs, pool, managers, host_ring, ring_es, poet_pool,
capture_under_load, durable, hier, sim_cluster, trace, serve);
then the
card's name and power limit as nvidia-smi reports them, the kernel
summary line, and as the last line ``{"ok": true, "device": {...}}``.
Any failed check raises, so the exit code is not 0 and no result line is
printed; so does a machine without CUDA, or a directory that holds this
script without the package.

f32 products of the plain versions run in full f32 (TF32 is switched
off), so kernel and plain version differ only in summation order.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
# Edge shapes whose inputs the flash kernels cannot copy in 16-byte
# units, so they take their scalar load paths: head_dim 20 in bf16 (not
# a whole number of 8-element vectors), and f32 tensors that start one
# element into their buffers (rows 4 bytes off 16-byte alignment).
# (name, S, heads, kv_heads, head_dim, dtype, window, causal, offset)
SCALAR_EDGE_SHAPES = (
    ("edge_d20_bf16_scalar", 70, 2, 1, 20, "bfloat16", None, True, 0),
    ("edge_d24_f32_unaligned", 90, 4, 2, 24, "float32", 7, True, 1),
)
# The ring's off-diagonal forward launch, timed: one rank's 4096-row
# block of bench.py --attention's shape against another rank's keys, not
# causal. (name, S, heads, kv_heads, head_dim, dtype, window, causal)
RING_BLOCK_SHAPE = ("ring_block_bf16_noncausal", 4096, 8, 8, 64, "bfloat16",
                    None, False)
# The multi-rank flash plane's blocks in lm_mesh_train, held untimed
# against the plain forward and backward: one rank's 4096-row f32 query
# block against another rank's keys (not causal) and against its own
# (causal). Their backward takes a random lse cotangent, as every block
# gets one from the merge of partial results.
# (name, S, heads, kv_heads, head_dim, dtype, window, causal)
MESH_BLOCK_SHAPES = (
    ("mesh_block_f32_noncausal", 4096, 8, 8, 32, "float32", None, False),
    ("mesh_block_f32_causal", 4096, 8, 8, 32, "float32", None, True),
)
# The 2-D data x sequence planes' forward launches in mesh_2d (a data
# row's batch of 1 folded into the heads), held untimed against the
# plain forward: the ring's 8192-row blocks against their own keys
# (causal) and the other rank's (not causal), and Ulysses' whole
# sequence over half the heads (causal).
GRID_BLOCK_SHAPES = (
    ("grid_ring_block_bf16_causal", 8192, 8, 8, 64, "bfloat16", None, True),
    ("grid_ring_block_bf16_noncausal", 8192, 8, 8, 64, "bfloat16", None,
     False),
    ("grid_ulysses_bf16_causal", 16384, 4, 4, 64, "bfloat16", None, True),
)
# Output tolerance by dtype: f32 results differ by summation order only;
# bf16 outputs may round to neighbouring bf16 values (one ulp at |o| ~ 4).
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
LSE_TOL = 1e-4
# Backward tolerance, max abs error over max |plain| of each gradient:
# f32 gradients differ by summation order only, dk and dv summing up to
# S x group rows (measured up to 7.9e-6 on an H100 at S = 16384 with GQA;
# the bound is 5e-5); bf16 gradients may round to neighbouring bf16 values.
BWD_TOL = {"float32": 5e-5, "bfloat16": 3e-2}
LM_CFG = dict(vocab=256, dim=256, heads=8, layers=4, max_seq=16384)
LM_TOL = 1e-4   # f32 logits of two attention engines, four layers
# Training: 5 timed AdamW steps after one warm-up (bench.py --lm); the
# flash-vs-reference gradient check runs at S = 2048, where the reference
# plane's scores under autograd fit (at 16384 they would be ~8.6 GB a
# layer). Tolerances are the JAX package's own flash-vs-reference ones.
TRAIN_STEPS = 5
GRAD_SEQ = 2048
GRAD_LOSS_TOL = 1e-4
GRAD_TOL = 5e-4
# The sequence-parallel planes: 4 ranks on the one card, bench.py
# --attention's 16384 tokens (bench.py:3141) cut into 4096-row blocks.
RANKS = 4
RING_SHAPE = (16384, 8, 64, "bfloat16")
# __graft_entry__.py's 2-D data x sequence composition at the ring
# phase's width: a 2 x 2 ("data", "seq") grid of the card's ranks,
# (batch, S, heads, head_dim) bf16 causal
GRID = (2, 2)
GRID_SHAPE = (2, 16384, 8, 64, "bfloat16")
# ring_exchange: (name, ranks, per-rank block shape of each array rotated
# together, dtype, offset in elements of every block from its buffer's
# start; 1 makes the pointers miss 16-byte alignment).
RING_EDGE = (
    ("edge_n2_k1", 2, [(64, 4, 8)], "float32", 0),
    ("edge_n3_k2_ragged", 3, [(13, 3, 5)] * 2, "float32", 0),
    ("edge_n8_k3_mixed", 8, [(13, 3, 5), (7, 2), (1,)], "float32", 0),
    ("edge_n8_k1_bf16", 8, [(33, 2, 3)], "bfloat16", 0),
    ("edge_n3_k2_unaligned", 3, [(100, 3)] * 2, "float32", 1),
)
# The main path's blocks, timed: K and V of the bf16 ring, the LM's GQA
# K/V, and the array each bf16 Ulysses swap rotates whole (the sequence
# shard in, the head shard of the output back).
RING_MAIN = (
    ("attention_bf16_kv", RANKS, [(4096, 8, 64)] * 2, "bfloat16", 0),
    ("lm_f32_gqa_kv", RANKS, [(4096, 2, 32)] * 2, "float32", 0),
    ("ulysses_bf16_swap_in", RANKS, [(4096, 8, 64)], "bfloat16", 0),
    ("ulysses_bf16_swap_out", RANKS, [(16384, 2, 64)], "bfloat16", 0),
)
# The blocks of lm_mesh's forwards, bitwise only: K and V of the ring and
# multi-rank flash planes, and the arrays of the Ulysses plane's swaps.
RING_LM = (
    ("lm_mesh_f32_kv", RANKS, [(4096, 8, 32)] * 2, "float32", 0),
    ("lm_mesh_f32_swap_in", RANKS, [(4096, 8, 32)], "float32", 0),
    ("lm_mesh_f32_swap_out", RANKS, [(16384, 2, 32)], "float32", 0),
)
# ring_attention runs whose device time is broken down by torch.profiler
PROFILED = ("ring_flash_dma", "ulysses_flash_dma")
# Inputs that the ring_exchange timings cycle through: four times the
# H100's 50 MB L2, so no call finds its inputs there.
L2_MISS_BYTES = 4 * 50 * 10**6
ES_RANK_TOL = 1e-5    # gradient of the 4-rank step vs a plain recomputation
# returns of a rank's 1024 members, rolled out alone, that may differ
# from the batched step's (another batch size, another rounding)
ES_LAYOUT_MISMATCHES = 10
# The ES flagship as bench.py times it: run_fused over --gens generations
# (bench.py's default 10), after a warm run_fused; Adam checked over 3.
ES_GENS = 10
ES_ADAM_GENS = 3
ES_PARAM_TOL = 1e-6   # fused vs eager params (the same kernels: 0 expected)
# The population-search families (es_families, novelty, map_elites,
# ask_tell, device_map): PGPE and SepCMAES as es_cartpole.py --algo
# pgpe|cma at the flagship's pop 4096 (bench.py), 500-step CartPole, MLP
# (32, 32); CMAES at es_cartpole.py --algo fullcma's default pop 1024.
FAMILY_POP = 4096
FAMILY_STEPS = 500
FAMILY_GENS = 10
FAMILY_MESH_GENS = 3
# one step over 4 ranks vs one rank: the same returns, sums per rank
FAMILY_MESH_TOL = 1e-5
CMA_POP = 1024
CMA_GENS = 3
# every family's step, card vs CPU, on the quadratic at dim 64, pop 64
SMOOTH_DIM = 64
SMOOTH_POP = 64
SMOOTH_TOL = 1e-5
# the card's eigh of the dim-64 C (||C|| <= 2): its residual, its
# orthogonality and its eigenvalues against the CPU's within a few
# n eps ||C|| (1.5e-5), the backward-error scale of an f32 symmetric
# eigensolver (measured on an H100: 6.3e-6, 1.2e-5 and 2.2e-5)
EIGH_TOL = 4 * SMOOTH_DIM * 2.0 ** -23 * 2
# CMAES's step with the card's own eigenvectors against the CPU's: the
# two solvers' vectors differ by up to 2.1e-5 (measured), and the
# evolution paths (entries up to 2) sum the weighted draws through them:
# 5.9e-5 measured on an H100, bound 2e-4
CMA_OWN_EIGH_TOL = 2e-4
# novelty_maze.py: pop 256, archive 128, k 10, 30 generations, its modes
NOVELTY_POP = 256
NOVELTY_GENS = 30
NOVELTY_MODES = (("NS-ES", 0.0, False), ("NSR-ES", 0.5, False),
                 ("NSRA-ES", 1.0, True))
NOVELTY_RATE_POP = 4096
# map_elites_maze.py: batch 256, 12 x 12 cells, 60 generations
MAP_ELITES_BATCH = 256
MAP_ELITES_GENS = 60
MAP_ELITES_RATE_BATCH = 4096
# es_pool_gym.py: 10 generations; ask/tell timed at the flagship's size
ASK_TELL_GENS = 10
ASK_TELL_POP = 4096
DMAP_ITEMS = 4096
# The user API (pool): Pool(POOL_DEVICE_WORKERS).starmap of a
# @meta(device=True) CartPole evaluation over DMAP_ITEMS pairs, with the
# flagship MLP (32, 32) and with POOL_WIDE_HIDDEN, whose f32 parameters
# (270 KB) go to every item as one shared numpy array; POOL_REPEATS maps
# of it make one tier put and POOL_REPEATS - 1 hits. Then
# POOL_HOST_WORKERS host workers take a POOL_TENSOR_MB MB CUDA tensor
# argument and return a CUDA tensor, POOL_TENSOR_ITEMS times.
POOL_DEVICE_WORKERS = 4
POOL_WIDE_HIDDEN = (256, 256)
POOL_REPEATS = 3
POOL_HOST_WORKERS = 2
POOL_TENSOR_MB = 8
POOL_TENSOR_ITEMS = 4
# The managers, the ring and the Pool-driven POET: a managed dict
# round-trips a MANAGER_TENSOR_MB MB CUDA tensor; RING_RANKS rank
# processes allreduce a HOST_RING_MB MB f32 CUDA tensor through HostRing
# HOST_RING_REPS times (after one warm-up), then run the flagship ES over
# a gloo process mesh for RING_ES_GENS generations, held against the
# single-process mesh of as many ranks under ES_LAYOUT_MISMATCHES a rank
# and generation; POET_POOL_WORKERS pool workers run bench.py --poet's
# width (POET_ES_STEPS ES steps a pair) for POET_POOL_ITERS iterations,
# held against the same loop in this process.
MANAGER_TENSOR_MB = 8
RING_RANKS = 2
HOST_RING_MB = 8
HOST_RING_REPS = 5
RING_ES_GENS = 3
POET_POOL_WORKERS = 2
POET_POOL_ITERS = 2
# EXIT_PROBE_CHILDREN processes on the card each probe the device gauges
# from a daemon thread without pause as they exit, and as many run the
# same loop on a bare ``torch.cuda.mem_get_info`` (the control).
EXIT_PROBE_CHILDREN = 3
# The rest of the host plane. ES's durable unit of work (README's
# ``Pool.map(..., job_id=...)``): DURABLE_ITEMS CartPole evaluations of
# DURABLE_POP flagship-MLP policies over DURABLE_STEPS steps each on the
# card, DURABLE_CHUNK a chunk, in a subprocess master that the port's
# chaos plan SIGKILLs once DURABLE_KILL_AFTER chunks are journaled; the
# CLI's ``resume`` finishes it. Before it, the same evaluations
# (CAPTURE_MAP_ITEMS of them, one a chunk) run as a durable map in a
# thread of this process while the main thread captures and replays one
# generation of the flagship ES (pop CAPTURE_POP, CAPTURE_STEPS steps)
# again and again. The hier pool maps HIER_ITEMS HIER_TENSOR_MB MB CUDA
# tensors and then HIER_KILL_ITEMS paced tasks across a SIGKILL of its
# sub-master; the sim:2 cluster runs SIM_ITEMS of the evaluations; the
# trace phase profiles a pool map and one flash_fwd call at
# TRACE_FLASH_SHAPE (bf16, causal); the serve daemon runs the hier
# phase's tensor map and a job of SERVE_CANCEL_ITEMS paced tasks that is
# cancelled.
DURABLE_ITEMS = 24
DURABLE_CHUNK = 2
DURABLE_POP = 1024
DURABLE_STEPS = 500
DURABLE_KILL_AFTER = 3
CAPTURE_MAP_ITEMS = 40
CAPTURE_POP = 4096
CAPTURE_STEPS = 500
HIER_ITEMS = 8
HIER_TENSOR_MB = 8
HIER_KILL_ITEMS = 240
SIM_ITEMS = 8
TRACE_FLASH_SHAPE = (4096, 8, 64)
SERVE_CANCEL_ITEMS = 200
# an HBM cell of `devices` and `top`: used/limit in numbers
HBM_CELL = re.compile(r"\d+(\.\d+)?(B|KB|MB|GB)/\d+\.\dGB")
# bench.py --poet (ParamCartPole, MLP (16,), pop 4096, 500 steps, 6
# pairs, 4 ES steps a pair), cut from bench.py's 10 iterations to 2;
# the card against the CPU on a small POET
POET_ITERS = 2
POET_ES_STEPS = 4
POET_SMALL = dict(pop=64, max_steps=60, max_pairs=6)
POET_SMALL_ITERS = 2
# POET over 4 ranks of the card: the small POET card against CPU, and
# one bench.py --poet iteration at full width
POET_MESH_ITERS = 1
# checkpoints: the flagship ES (Adam) resumed after 2 of 4 generations,
# the small POET after 1 of 2 iterations
CKPT_ES_GENS = 2
CKPT_POET_ITERS = 1
# bench.py --profile: one timed run_fused generation of the flagship in
# a torch.profiler trace, written under TRACE_DIR (gitignored)
TRACE_DIR = ".traces"
# bench.py --biped (pop 4096, 400 steps) and --pixels (pop 1024, 60
# steps) through run_fused, cut from bench.py's default 10 generations
# to 5
ES_ENV_GENS = 5
# the other envs and policies, one ES step each, card against CPU at
# pop 4096 (CartPole episodes of 200 steps): survival returns that agree
# exactly on ENV_SURVIVAL_SHARE of the members (as phase_es); continuous
# ones within ENV_RETURN_TOL relative on ENV_CONTINUOUS_SHARE. The hill
# walker's terrain amplifies f32 differences about tenfold every 20
# steps (tests/test_torch_envs.py), so some of its 200-step episodes
# part: 95.9% within 1e-3 on an H100 (GRU and bf16 MLP 100%, Pendulum
# 99.98%)
ENV_CHECK_POP = 4096
ENV_CHECK_STEPS = 200
ENV_SURVIVAL_SHARE = 0.95
ENV_CONTINUOUS_SHARE = 0.9
ENV_RETURN_TOL = 1e-3
# the biped's 400 steps, card against CPU, on 1024 members (reported)
BIPED_CHECK_POP = 1024
# The C interface's dtype codes
DTYPE_CODE = {"float": 0, "bfloat16": 1}
# What runs the products of the flash kernels, by input type
ENGINE = {"float32": "mma.sync 3xtf32", "bfloat16": "mma.sync bf16"}
# The kernels on the tensor cores: HMMA in their SASS, no spills in any of
# their 8 templates (f32 and bf16 at head_dim 16, 32, 64 and 128), and a
# C function that gives each template's shared memory
TENSOR_CORE_LIBS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SOURCES = {"flash_fwd": "fiber_tpu_torch/csrc/flash_fwd.cu",
           "flash_bwd_dq": "fiber_tpu_torch/csrc/flash_bwd_dq.cu",
           "flash_bwd_dkv": "fiber_tpu_torch/csrc/flash_bwd_dkv.cu",
           "ring_exchange": "fiber_tpu_torch/csrc/dma_ring.cu"}
REPLACES = {"flash_fwd": "fiber_tpu/ops/pallas_attention.py:68",
            "flash_bwd_dq": "fiber_tpu/ops/pallas_attention.py:170",
            "flash_bwd_dkv": "fiber_tpu/ops/pallas_attention.py:208",
            "ring_exchange": "fiber_tpu/ops/dma_ring.py:71"}


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


def graph_ms(torch, fns, reps, replays=5):
    """Device time of one call in ms, for calls whose host-side enqueue
    outlasts their device work: ``reps`` calls, cycling through ``fns``
    (the same function on distinct inputs, so that inputs can be made
    to miss the L2 cache), captured in one CUDA graph and replayed
    ``replays`` times between CUDA events."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def device_breakdown(torch, fn):
    """Where one call's device time goes, by ``torch.profiler``: ms and
    launches of ``flash_fwd``, ``ring_exchange`` and every other device
    activity (PyTorch's elementwise and copy kernels), their busy sum,
    the span from the first start to the last end, and the idle share
    of that span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    parts = {"flash_fwd": [0.0, 0], "ring_exchange": [0.0, 0],
             "other": [0.0, 0]}
    starts, ends = [], []
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA
                or e.name.startswith("Activity Buffer")):
            continue
        part = next((k for k in ("flash_fwd", "ring_exchange")
                     if f"{k}_kernel" in e.name), "other")
        parts[part][0] += e.time_range.elapsed_us() / 1e3
        parts[part][1] += 1
        starts.append(e.time_range.start)
        ends.append(e.time_range.end)
    check(starts, "the profiler saw no device activity")
    busy = sum(ms for ms, _ in parts.values())
    span = (max(ends) - min(starts)) / 1e3
    return {"ms": {k: v[0] for k, v in parts.items()},
            "launches": {k: v[1] for k, v in parts.items()},
            "busy_ms": busy, "span_ms": span, "idle_share": 1 - busy / span}


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
    check({"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "dma_ring"}
          <= set(libs), f"kernels missing from the build: {sorted(libs)}")
    # The flash kernels' products run on the tensor cores: their SASS
    # holds HMMA instructions (counted where the toolkit has cuobjdump).
    hmma = {k: _build.sass_count(k, "HMMA") for k in libs}
    ptxas = {k: _build.ptxas_report(k) for k in libs}
    for name in TENSOR_CORE_LIBS:
        check(hmma[name] is None or hmma[name] > 0,
              f"{name}'s SASS holds no HMMA instruction")
        # Every template: no spills, and its shared memory per block.
        smem = getattr(ctypes.CDLL(str(libs[name])), f"{name}_smem_bytes")
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        for row in ptxas[name]:
            dtype, dp = re.search(r"<(\w+),(\d+)>",
                                  row["function"]).groups()
            row["smem_bytes"] = smem(int(dp), DTYPE_CODE[dtype])
            check(row["spill_stores"] == row["spill_loads"] == 0,
                  f"{row['function']} spills")
        check(len(ptxas[name]) == 8,
              f"{name} templates built: {ptxas[name]}")
    emit({"phase": "build", "seconds": secs,
          "libraries": {k: v.name for k, v in libs.items()},
          "sass_hmma": hmma, "ptxas": ptxas})


def _randn(torch, shape, dtype, g, offset=0):
    """A random (S, heads, head_dim) tensor that starts ``offset``
    elements into its own buffer."""
    s, n, d = shape
    return (torch.randn(offset + s * n * d, generator=g, device="cuda")
            .to(dtype)[offset:].view(s, n, d))


def _inputs(torch, s, h, kvh, d, dtype, seed, offset=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(_randn(torch, (s, n, d), dtype, g, offset)
                 for n in (h, kvh, kvh))


def _sdpa_call(torch, window, s, gqa, causal=True):
    """The library's attention as one call on (1, heads, S, head_dim)
    tensors, for timing only: causal or not, GQA by ``enable_gqa``, the
    window by an explicit boolean mask."""
    F = torch.nn.functional
    if window is None:
        return lambda qt, kt, vt: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=gqa)
    pos = torch.arange(s, device="cuda")
    diff = pos[:, None] - pos[None, :]
    mask = (diff >= 0) & (diff < window)
    return lambda qt, kt, vt: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=gqa)


def _sdpa(torch, q, k, v, window, causal=True):
    """The library's attention forward on the same inputs."""
    call = _sdpa_call(torch, window, q.shape[0], k.shape[1] != q.shape[1],
                      causal)
    qt, kt, vt = (x.permute(1, 0, 2).unsqueeze(0) for x in (q, k, v))
    return lambda: call(qt, kt, vt)


def _sdpa_bwd(torch, q, k, v, dout, window):
    """The library's attention backward alone on the same inputs: one
    forward with grad, then the timed call is ``autograd.grad`` of it."""
    call = _sdpa_call(torch, window, q.shape[0], k.shape[1] != q.shape[1])
    qt, kt, vt = (x.permute(1, 0, 2).unsqueeze(0).detach().requires_grad_()
                  for x in (q, k, v))
    out = call(qt, kt, vt)
    dot = dout.permute(1, 0, 2).unsqueeze(0)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def phase_kernels(torch, card):
    from fiber_tpu_torch.ops import flash_attention as fa
    from fiber_tpu_torch.utils import flops

    rows = []
    edges = [e + (0,)
             for e in EDGE_SHAPES + MESH_BLOCK_SHAPES + GRID_BLOCK_SHAPES]
    edges += list(SCALAR_EDGE_SHAPES)
    for name, s, h, kvh, d, dt, window, causal, offset in edges:
        dtype = getattr(torch, dt)
        q, k, v = _inputs(torch, s, h, kvh, d, dtype, seed=len(rows),
                          offset=offset)
        o, lse = fa.flash_fwd(q, k, v, causal=causal, window=window)
        ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal,
                                                window=window)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        check(err < TOL[dt] and lse_err < LSE_TOL,
              f"{name}: max_abs_err {err} lse_err {lse_err}")
        rows.append({"shape": name, "offset": offset, "engine": ENGINE[dt],
                     "max_abs_err": err, "lse_err": lse_err,
                     "tol": TOL[dt]})

    main = {}
    timed = [m + (True,) for m in MAIN_SHAPES] + [RING_BLOCK_SHAPE]
    for name, s, h, kvh, d, dt, window, causal in timed:
        dtype = getattr(torch, dt)
        q, k, v = _inputs(torch, s, h, kvh, d, dtype, seed=len(rows))
        kw = dict(causal=causal, window=window)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        check(bool(torch.isfinite(o.float()).all()), f"{name}: non-finite")
        check(err < TOL[dt] and lse_err < LSE_TOL,
              f"{name}: max_abs_err {err} lse_err {lse_err}")
        del ro, rlse
        ms = cuda_ms(torch, lambda: fa.flash_fwd(q, k, v, **kw), reps=10)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_reference(
            q, k, v, **kw), reps=3)
        library_ms = cuda_ms(torch, _sdpa(torch, q, k, v, window, causal),
                             reps=5)
        n_flops = flops.attention_flops(s, h, d, **kw)
        nbytes = (q.nbytes + k.nbytes + v.nbytes + o.nbytes + lse.nbytes)
        bound, bound_by = flops.bound_ms(n_flops, nbytes, dt)
        row = {"shape": name, "S": s, "heads": h, "kv_heads": kvh,
               "head_dim": d, "dtype": dt, "window": window,
               "causal": causal, "engine": ENGINE[dt],
               "max_abs_err": err, "lse_err": lse_err, "tol": TOL[dt],
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound, "bound_by": bound_by,
               "peak_flops": flops.op_peak(dt)[0],
               "bound_engine": flops.op_peak(dt)[1],
               "tflops": n_flops / ms / 1e9}
        rows.append(row)
        main[name] = row
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "card": card, "flash_fwd_launches":
          fa.flash_fwd.launches, "shapes": rows})
    return main


def _bwd_errors(got, want):
    """(max abs error, max abs error over max |plain|) over gradients."""
    abs_err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
    rel = max((g.float() - w.float()).abs().max().item()
              / w.float().abs().max().item() for g, w in zip(got, want))
    return abs_err, rel


def _bwd_times(torch, q, k, v, dout, lse, delta, window):
    """Device times of both backward kernels, their plain versions and
    the library's backward at one main shape, with each kernel's bound
    (attention_bwd_flops over flops.op_peak's rate for the inputs' type,
    3xTF32 for f32, or its bytes over the memory rate: inputs read once,
    outputs written once)."""
    from fiber_tpu_torch.ops import flash_attention as fa
    from fiber_tpu_torch.utils import flops

    s, h, d = q.shape
    dt = str(q.dtype).removeprefix("torch.")
    args, kw = (q, k, v, dout, lse, delta), dict(causal=True, window=window)
    kernels = {"dq": fa.flash_bwd_dq, "dkv": fa.flash_bwd_dkv}
    plain = {"dq": dict(dkv=False), "dkv": dict(dq=False)}
    in_bytes = sum(x.nbytes for x in args)
    out_bytes = {"dq": q.nbytes, "dkv": k.nbytes + v.nbytes}
    row = {}
    for part, kernel in kernels.items():
        ms = cuda_ms(torch, lambda: kernel(*args, **kw), reps=5)
        n_flops = flops.attention_bwd_flops(s, h, d, window=window,
                                            part=part)
        bound, bound_by = flops.bound_ms(n_flops, in_bytes + out_bytes[part],
                                         dt)
        row[part] = {
            "ms": ms, "bound_ms": bound, "bound_by": bound_by,
            "bound_engine": flops.op_peak(dt)[1],
            "tflops": n_flops / ms / 1e9,
            "plain_ms": cuda_ms(torch, lambda: fa.flash_bwd_reference(
                *args, **kw, **plain[part]), reps=2)}
    row["library_ms"] = cuda_ms(
        torch, _sdpa_bwd(torch, q, k, v, dout, window), reps=3)
    return row


def phase_kernels_bwd(torch, card):
    """Both backward kernels against the plain backward at every edge,
    mesh-block and main shape, from the forward kernel's (O, lse) and a random dO; a
    random lse cotangent on the edge and mesh-block shapes and on one
    main shape. At the main shapes a second launch of each kernel on the
    same inputs must give the same dq, dk and dv bit for bit (no
    atomics, a fixed order)."""
    from fiber_tpu_torch.ops import flash_attention as fa
    from fiber_tpu_torch.utils import flops

    shapes = [e + (True, 0) for e in EDGE_SHAPES + MESH_BLOCK_SHAPES]
    shapes += [e[:8] + (True, e[8]) for e in SCALAR_EDGE_SHAPES]
    shapes += [m + (True, m[0] == "lm_f32_gqa", 0) for m in MAIN_SHAPES]
    rows, main = [], {}
    for name, s, h, kvh, d, dt, window, causal, with_dlse, offset in shapes:
        dtype = getattr(torch, dt)
        seed = 100 + len(rows)
        q, k, v = _inputs(torch, s, h, kvh, d, dtype, seed=seed,
                          offset=offset)
        o, lse = fa.flash_fwd(q, k, v, causal=causal, window=window)
        g = torch.Generator(device="cuda").manual_seed(seed + 50)
        dout = _randn(torch, (s, h, d), dtype, g, offset)
        dlse = (torch.randn(h, s, generator=g, device="cuda")
                if with_dlse else None)
        delta = fa.flash_bwd_delta(o, dout, dlse)
        kw = dict(causal=causal, window=window)
        dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, dout, dlse,
                                                **kw)
        dq_err, dq_rel = _bwd_errors([dq], want[:1])
        dkv_err, dkv_rel = _bwd_errors([dk, dv], want[1:])
        del want
        check(all(bool(torch.isfinite(x.float()).all())
                  for x in (dq, dk, dv)), f"{name}: non-finite gradients")
        check(dq_rel < BWD_TOL[dt] and dkv_rel < BWD_TOL[dt],
              f"{name}: dq rel err {dq_rel}, dk/dv rel err {dkv_rel}")
        row = {"shape": name, "S": s, "heads": h, "kv_heads": kvh,
               "head_dim": d, "dtype": dt, "window": window,
               "causal": causal, "dlse": with_dlse, "offset": offset,
               "tol": BWD_TOL[dt],
               "dq_engine": ENGINE[dt], "dkv_engine": ENGINE[dt],
               "dq_max_abs_err": dq_err, "dq_rel_err": dq_rel,
               "dkv_max_abs_err": dkv_err, "dkv_rel_err": dkv_rel}
        if s == LM_CFG["max_seq"]:
            dq2 = fa.flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
            dk2, dv2 = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
            torch.cuda.synchronize()
            check(torch.equal(_bits(torch, dq), _bits(torch, dq2)),
                  f"{name}: two flash_bwd_dq launches differ")
            check(torch.equal(_bits(torch, dk), _bits(torch, dk2))
                  and torch.equal(_bits(torch, dv), _bits(torch, dv2)),
                  f"{name}: two flash_bwd_dkv launches differ")
            row["dq_bitwise_repeat"] = row["dkv_bitwise_repeat"] = True
            del dq2, dk2, dv2
            row.update(_bwd_times(torch, q, k, v, dout, lse, delta, window))
            main[name] = row
        rows.append(row)
        del q, k, v, o, lse, dout, dlse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    emit({"phase": "kernels_bwd", "card": card,
          "peak_flops": {dt: flops.op_peak(dt) for dt in BWD_TOL},
          "shapes": rows})
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


def _grad_check(torch):
    """Flash against reference TinyLM at S = GRAD_SEQ, full width, one
    random weight tree: the loss and every parameter's gradient."""
    from fiber_tpu_torch.models import convert
    from fiber_tpu_torch.models.transformer import TinyLM

    cfg = dict(LM_CFG, max_seq=GRAD_SEQ)
    state = convert.tinylm_params_from_jax(
        convert.random_tinylm_tree(**cfg, seed=0), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg["vocab"], (GRAD_SEQ,), generator=g,
                           device="cuda")
    losses, grads = {}, {}
    for attention in ("flash", "reference"):
        m = TinyLM(**cfg, attention=attention, device="cuda")
        m.load_state_dict(state)
        loss = m.loss(tokens)
        loss.backward()
        losses[attention] = loss.item()
        grads[attention] = {n: p.grad for n, p in m.named_parameters()}
    loss_err = abs(losses["flash"] - losses["reference"])
    grad_err = max((grads["flash"][n] - grads["reference"][n]).abs().max()
                   .item() for n in grads["flash"])
    max_grad = max(x.abs().max().item() for x in grads["reference"].values())
    check(loss_err < GRAD_LOSS_TOL,
          f"S={GRAD_SEQ}: flash vs reference loss differ by {loss_err}")
    check(grad_err < GRAD_TOL,
          f"S={GRAD_SEQ}: flash vs reference gradients differ by {grad_err}")
    return {"S": GRAD_SEQ, "loss": losses["flash"], "loss_err": loss_err,
            "loss_tol": GRAD_LOSS_TOL, "max_grad_err": grad_err,
            "grad_tol": GRAD_TOL, "max_abs_grad": max_grad}


def phase_lm_train(torch):
    from fiber_tpu_torch.entry import LM_WIDTHS, train_lm
    from fiber_tpu_torch.models.transformer import (
        TinyLM,
        adamw,
        make_train_step,
    )
    from fiber_tpu_torch.ops import flash_attention as fa
    from fiber_tpu_torch.utils import flops

    seq = LM_CFG["max_seq"]
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, secs = train_lm(device="cuda", seq=seq, steps=TRAIN_STEPS)
    launches = {kernel.__name__: kernel.launches for kernel in kernels}
    peak_bytes = torch.cuda.max_memory_allocated()
    steps_run = TRAIN_STEPS + 1                  # the warm-up step too
    for name, n in launches.items():
        check(n == LM_CFG["layers"] * steps_run,
              f"{name} launched {n} times in {steps_run} steps, want "
              f"{LM_CFG['layers']} a step")
    check(bool(torch.isfinite(losses).all()), f"losses {losses.tolist()}")
    check(float(losses[-1]) < float(losses[0]),
          f"loss did not fall on one batch: {losses.tolist()}")

    # Device time of one step, same configuration, by CUDA events.
    model = TinyLM(**LM_WIDTHS, max_seq=seq, attention="flash",
                   device="cuda", generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, adamw(model.parameters(), 1e-3))
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, LM_WIDTHS["vocab"], (seq,), generator=g,
                           device="cuda")
    step_ms = cuda_ms(torch, lambda: step(tokens), reps=3)
    n_flops = flops.tinylm_flops_per_step(model, seq, train=True)
    del model, step, tokens
    torch.cuda.empty_cache()
    grad = _grad_check(torch)
    emit({"phase": "lm_train", **LM_CFG, "attention": "flash",
          "optimizer": "adamw(1e-3)", "steps": TRAIN_STEPS,
          "losses": losses.tolist(), "seconds": secs,
          "tokens_per_s": seq * TRAIN_STEPS / secs, "step_ms": step_ms,
          "model_flops_per_step": n_flops,
          "tflops": n_flops / step_ms / 1e9,
          "launches": launches,
          "launches_per_step": {k: n / steps_run
                                for k, n in launches.items()},
          "peak_memory_bytes": peak_bytes, "grad_check": grad})
    return launches


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
    new_params, stats, perf = run_es(device="cuda", pop=pop,
                                     max_steps=steps, generations=gens)
    torch.cuda.synchronize()
    es_secs = time.perf_counter() - t0
    check(bool(torch.isfinite(stats).all()), f"stats {stats.tolist()}")
    check(bool(torch.isfinite(new_params).all()), "non-finite params")
    _check_mfu(perf, "run_es")
    fused = _es_fused(torch, _flagship_es(torch, pop, steps), ES_GENS,
                      profile=True)
    fused.update(_es_rates(torch, "cartpole", fused, pop, steps))
    adam = _es_fused(torch, _flagship_es(torch, pop, steps, optimizer="adam"),
                     ES_ADAM_GENS)
    emit({"phase": "es", "pop": pop, "max_steps": steps, "hidden": [32, 32],
          "sigma": 0.1, "lr": 0.03, "card_vs_cpu_same_returns": same,
          "eval_seconds": eval_secs, "eval_evals_per_s": pop / eval_secs,
          "run_es_generations": gens, "run_es_seconds": es_secs,
          "run_es_stats": stats.tolist(), "run_es_perf": perf,
          "fused": fused,
          "fused_adam": adam, "trace": _traced_generation(torch, pop, steps)})


def _check_mfu(perf, label):
    """On an H100 the rate fields carry an MFU against the table's H100
    row (or FIBER_PEAK_FLOPS's override)."""
    check(perf["mfu"] is not None and perf["mfu"] > 0
          and perf["peak_row"] is not None, f"{label}: no MFU on the card: "
          f"{perf}")


def _es_rates(torch, env, row, pop=None, steps=None):
    """bench.py's rate fields (``entry.throughput``) of a ``_es_fused``
    row's timed run_fused of ``make_es(env, pop=pop,
    max_steps=steps)``: ``es_flops_per_gen`` of its policy a
    generation, over the card's peak."""
    from fiber_tpu_torch.entry import _es_setup, throughput
    from fiber_tpu_torch.utils import flops

    es, _, policy, env_name, steps = _es_setup(
        env, "cpu", pop, steps, 0.1, 0.03, 0)
    gens = row["generations"]
    perf = throughput(
        es.pop_size * gens, gens * flops.es_flops_per_gen(
            policy, env_name, steps, es.pop_size, policy.dim),
        row["fused_seconds"], [torch.device("cuda")])
    _check_mfu(perf, f"{env} run_fused")
    del perf["seconds"]             # the row's fused_seconds
    return perf


def _traced_generation(torch, pop, steps):
    """bench.py --profile: one timed ``run_fused`` generation of the
    flagship (captured before) inside ``profiling.trace``, with a
    ``profiling.annotate`` region around it. The Chrome trace under
    TRACE_DIR must hold the annotation and the generation's kernels."""
    from fiber_tpu_torch.utils.profiling import TRACE_FILE, annotate, trace

    start = time.perf_counter()
    es, params = _flagship_es(torch, pop, steps)
    es.run_fused(params, 1)
    log_dir = os.path.join(TRACE_DIR, "es")
    with trace(log_dir):
        with annotate("es.run_fused"):
            t0 = time.perf_counter()
            es.run_fused(params, 1)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    path = os.path.join(log_dir, TRACE_FILE)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    check(kernels > 0, f"the trace {path} holds no kernel event")
    check(any(e.get("name") == "es.run_fused" for e in events),
          f"the trace {path} lacks its annotation")
    return {"path": path, "bytes": os.path.getsize(path),
            "events": len(events), "kernel_events": kernels,
            "traced_seconds": secs,
            "phase_seconds": time.perf_counter() - start}


def _flagship_es(torch, pop, steps, optimizer="sgd", ranks=1):
    """The flagship strategy as ``entry.run_es`` builds it (sigma 0.1, lr
    0.03, generator seed 1) over ``ranks`` ranks of the card, and its
    initial params (seed 0)."""
    from fiber_tpu_torch.entry import flagship_policy
    from fiber_tpu_torch.models.envs import CartPole
    from fiber_tpu_torch.ops.es import EvolutionStrategy
    from fiber_tpu_torch.parallel.mesh import make_mesh

    policy = flagship_policy()
    es = EvolutionStrategy(
        lambda thetas, states: CartPole.rollout(
            policy.act, thetas, states, max_steps=steps),
        CartPole.reset, dim=policy.dim, pop_size=pop, sigma=0.1, lr=0.03,
        optimizer=optimizer, mesh=make_mesh("cuda", n=ranks),
        generator=torch.Generator(device="cuda").manual_seed(1))
    return es, policy.init(torch.Generator().manual_seed(0), device="cuda")


def _es_fused(torch, es_params, gens, profile=False):
    """``run_fused`` over ``gens`` generations against as many eager
    ``step`` calls from the same params, generator state and optimizer
    state: stats exactly equal, params within ES_PARAM_TOL (and whether
    bitwise), the generator's state after both equal (and Adam's). Then
    evals/s of a timed ``run_fused`` after that warm one, and of the
    eager steps; with ``profile``, the device busy time, span, idle
    share and launches of one eager generation and of one replay."""
    es, params = es_params
    gen0 = es.generator.get_state()
    opt0 = es._opt_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused_p, fused_s = es.run_fused(params, gens)      # captures, warm
    torch.cuda.synchronize()
    first_secs = time.perf_counter() - t0
    fused_gen, fused_opt = es.generator.get_state(), es._opt_state

    es.generator.set_state(gen0)
    es._opt_state = opt0
    p, rows = params, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(gens):
        p, s = es.step(p)
        rows.append(s)
    torch.cuda.synchronize()
    eager_secs = time.perf_counter() - t0
    eager_s = torch.stack(rows)
    check(torch.equal(fused_s, eager_s), f"fused stats {fused_s.tolist()} "
          f"differ from eager {eager_s.tolist()}")
    err = (fused_p - p).abs().max().item()
    check(err <= ES_PARAM_TOL, f"fused params differ from eager by {err}")
    check(torch.equal(fused_gen, es.generator.get_state()),
          "the generator's state differs after the fused and eager runs")
    if es.optimizer == "adam":
        check(all(torch.equal(a, b) for a, b in zip(fused_opt,
                                                     es._opt_state)),
              "Adam's state differs after the fused and eager runs")
        check(float(es._opt_state[2]) == gens, "Adam's t did not count "
              "the generations")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2, s2 = es.run_fused(fused_p, gens)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(bool(torch.isfinite(s2).all()) and bool(torch.isfinite(p2).all()),
          f"fused stats {s2.tolist()}")
    row = {"optimizer": es.optimizer, "ranks": es.mesh.n_dev,
           "generations": gens, "stats_equal": True,
           "params_bitwise": bool(torch.equal(fused_p, p)),
           "params_max_abs_err": err, "params_tol": ES_PARAM_TOL,
           "generator_state_equal": True,
           "first_call_seconds": first_secs, "fused_seconds": secs,
           "fused_evals_per_s": gens * es.pop_size / secs,
           "eager_seconds": eager_secs,
           "eager_evals_per_s": gens * es.pop_size / eager_secs,
           "stats": s2.tolist()}
    if profile:
        graph = es._fused_runner_cache[gens].graph
        row["eager_generation"] = device_breakdown(torch,
                                                   lambda: es.step(p2))
        row["replay"] = device_breakdown(torch, graph.replay)
        row["replay_ms"] = cuda_ms(torch, graph.replay, reps=5)
    return row


def _kernels():
    """Every kernel wrapper of the port, each with its launch count."""
    from fiber_tpu_torch.ops import dma_ring
    from fiber_tpu_torch.ops import flash_attention as fa

    return (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
            dma_ring.ring_exchange)


def _reset_counts():
    for kernel in _kernels():
        kernel.launches = 0


def _counts():
    return {kernel.__name__: kernel.launches for kernel in _kernels()}


def _bits(torch, x):
    return x.contiguous().view(torch.uint8)


def _ring_blocks(torch, n, shapes, dt, offset, seed):
    """``arrays[j][r]``: array j's contiguous block on rank r, random,
    starting ``offset`` elements into its own buffer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    arrays = []
    for shape in shapes:
        numel = 1
        for dim in shape:
            numel *= dim
        arrays.append([
            torch.randn(offset + numel, generator=g, device="cuda")
            .to(getattr(torch, dt))[offset:].view(shape)
            for _ in range(n)])
    return arrays


def phase_kernels_ring(torch, card):
    """``ring_exchange`` against its plain version, bit for bit, at the
    edge, main and lm_mesh shapes; at the main shapes also its time, the
    plain version's, one ``torch.roll`` of the rank-stacked blocks (the
    library's single call for the same rotation, timed only) and the
    bound: the bytes it moves (every block read once and written once)
    over the memory rate. The three times are device times from CUDA
    graphs (``graph_ms``) that cycle through copies of the inputs
    holding at least L2_MISS_BYTES, so that, as the bound assumes, each
    call reads its inputs from device memory; ``eager_ms`` is the
    kernel's wrapper called back to back on one set of inputs, host
    enqueue included."""
    from fiber_tpu_torch.ops import dma_ring
    from fiber_tpu_torch.parallel.mesh import make_mesh
    from fiber_tpu_torch.utils import flops

    rows, main = [], {}
    for name, n, shapes, dt, offset in RING_EDGE + RING_MAIN + RING_LM:
        mesh = make_mesh("cuda", n=n)
        arrays = _ring_blocks(torch, n, shapes, dt, offset,
                              seed=200 + len(rows))
        before = [[_bits(torch, x).clone() for x in a] for a in arrays]
        got = dma_ring.ring_exchange(arrays, mesh)
        want = dma_ring.ring_exchange_reference(arrays, mesh)
        torch.cuda.synchronize()
        pairs = [(g, w) for gs, ws in zip(got, want) for g, w in zip(gs, ws)]
        check(all(torch.equal(_bits(torch, g), _bits(torch, w))
                  for g, w in pairs), f"{name}: not bitwise equal")
        check(all(torch.equal(_bits(torch, got[j][(r + 1) % n]),
                              before[j][r])
                  for j in range(len(arrays)) for r in range(n)),
              f"{name}: a block did not land on the next rank")
        check(all(torch.equal(_bits(torch, x), b)
                  for a, bs in zip(arrays, before) for x, b in zip(a, bs)),
              f"{name}: the inputs changed")
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in pairs)
        nbytes = flops.ring_exchange_bytes(arrays)
        row = {"shape": name, "ranks": n, "blocks": shapes, "dtype": dt,
               "offset": offset, "bytes_moved": nbytes,
               "bitwise_equal": True, "max_abs_err": err}
        if any(name == m[0] for m in RING_MAIN):
            stacked = torch.stack([torch.stack(a) for a in arrays])
            rolled = torch.roll(stacked, 1, dims=1)
            check(all(torch.equal(_bits(torch, rolled[j, r]),
                                  _bits(torch, got[j][r]))
                      for j in range(len(arrays)) for r in range(n)),
                  f"{name}: torch.roll disagrees with the kernel")
            sets = [arrays] + [[[x.clone() for x in a] for a in arrays]
                               for _ in range(L2_MISS_BYTES // (nbytes // 2))]
            stacks = [torch.stack([torch.stack(a) for a in c]) for c in sets]
            reps = max(24, len(sets))
            ms = graph_ms(torch, [
                lambda c=c: dma_ring.ring_exchange(c, mesh) for c in sets],
                reps)
            plain_ms = graph_ms(torch, [
                lambda c=c: dma_ring.ring_exchange_reference(c, mesh)
                for c in sets], reps)
            library_ms = graph_ms(torch, [
                lambda t=t: torch.roll(t, 1, dims=1) for t in stacks], reps)
            eager_ms = cuda_ms(torch, lambda: dma_ring.ring_exchange(
                arrays, mesh), reps=50, warmup=3)
            row.update(timed_input_sets=len(sets))
            del sets, stacks
            bound, bound_by = flops.bound_ms(0, nbytes, dt)
            row.update(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                       library_ms=library_ms,
                       library_call="torch.roll", bound_ms=bound,
                       bound_by=bound_by, gb_per_s=nbytes / ms / 1e6)
            main[name] = row
            del stacked, rolled
        rows.append(row)
        del arrays, before, got, want, pairs
    torch.cuda.empty_cache()
    emit({"phase": "kernels_ring", "card": card, "shapes": rows})
    return main


def phase_ring_attention(torch, card):
    """Ring and Ulysses attention at full width on RANKS ranks of the
    card, against single-device flash attention on the same inputs, with
    every kernel's launches per call counted, and the device time of the
    PROFILED calls broken down by kernel. Returns the counts of the main
    path, the causal flash ring over the ``ring_exchange`` kernel."""
    from fiber_tpu_torch.ops import flash_attention as fa
    from fiber_tpu_torch.ops.ring_attention import ring_attention
    from fiber_tpu_torch.ops.ulysses_attention import ulysses_attention
    from fiber_tpu_torch.parallel.mesh import make_mesh

    n = RANKS
    mesh = make_mesh("cuda", n=n)
    blocks = n + n * (n - 1) // 2       # diagonal and past blocks
    runs = {}

    def run(label, fn, ref, tol, flash, exchange):
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = _counts()
        want = {"flash_fwd": flash, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "ring_exchange": exchange}
        check(counts == want, f"{label}: launches {counts}, want {want}")
        check(out.shape == ref.shape and bool(torch.isfinite(
            out.float()).all()), f"{label}: shape or non-finite values")
        err = (out.float() - ref.float()).abs().max().item()
        check(err < tol, f"{label}: max_abs_err {err} vs single-device "
              f"flash, tol {tol}")
        runs[label] = {"launches": counts, "max_abs_err": err, "tol": tol,
                       "ms": cuda_ms(torch, fn, reps=3)}
        if label in PROFILED:
            runs[label]["device"] = device_breakdown(torch, fn)
        return counts

    s, h, d, dt = RING_SHAPE
    q, k, v = _inputs(torch, s, h, h, d, getattr(torch, dt), seed=300)
    ref = fa.flash_fwd(q, k, v, causal=True)[0]
    single_ms = cuda_ms(torch, lambda: fa.flash_fwd(q, k, v, causal=True),
                        reps=3)
    main = run("ring_flash_dma", lambda: ring_attention(
        q, k, v, mesh, causal=True, local="flash", use_dma_ring=True),
        ref, TOL[dt], blocks, n - 1)
    run("ring_flash_copies", lambda: ring_attention(
        q, k, v, mesh, causal=True, local="flash", use_dma_ring=False),
        ref, TOL[dt], blocks, 0)
    run("ulysses_flash_dma", lambda: ulysses_attention(
        q, k, v, mesh, causal=True, local="flash", use_dma_ring=True),
        ref, TOL[dt], n, 4 * (n - 1))
    del q, k, v, ref
    q, k, v = _inputs(torch, s, 8, 2, 32, torch.float32, seed=301)
    ref = fa.flash_fwd(q, k, v, causal=True)[0]
    run("ring_flash_dma_lm_gqa_f32", lambda: ring_attention(
        q, k, v, mesh, causal=True, local="flash", use_dma_ring=True),
        ref, TOL["float32"], blocks, n - 1)
    del q, k, v, ref
    torch.cuda.empty_cache()
    emit({"phase": "ring_attention", "card": card, "ranks": n,
          "S": s, "heads": h, "head_dim": d, "dtype": dt, "causal": True,
          "lm_gqa_shape": [s, 8, 2, 32, "float32"],
          "single_device_flash_ms": single_ms, "runs": runs})
    return main


def phase_mesh_2d(torch, card):
    """Ring and Ulysses attention (``local="flash"``) on a GRID
    ``("data", "seq")`` mesh of the card's ranks at GRID_SHAPE causal,
    each data row's batch folded into the heads: every batch element
    against single-device ``flash_fwd`` on it, within the ring phase's
    tolerance, with every kernel's launches per call (each row: the
    ring's diagonal and past blocks and s - 1 rotations; Ulysses' s
    local launches and 4 (s - 1) rotations)."""
    from fiber_tpu_torch.ops import flash_attention as fa
    from fiber_tpu_torch.ops.ring_attention import ring_attention
    from fiber_tpu_torch.ops.ulysses_attention import ulysses_attention
    from fiber_tpu_torch.parallel.mesh import make_mesh

    start = time.perf_counter()
    d, s_ranks = GRID
    mesh = make_mesh("cuda", shape=GRID, names=("data", "seq"))
    b, s, h, hd, dt = GRID_SHAPE
    g = torch.Generator(device="cuda").manual_seed(310)
    q, k, v = (torch.randn(b, s, h, hd, generator=g, device="cuda")
               .to(getattr(torch, dt)) for _ in range(3))
    refs = [fa.flash_fwd(q[i], k[i], v[i], causal=True)[0] for i in range(b)]
    single_ms = cuda_ms(torch, lambda: [fa.flash_fwd(
        q[i], k[i], v[i], causal=True) for i in range(b)], reps=3)
    runs, launches = {}, {}
    planes = (
        ("ring_flash", lambda: ring_attention(q, k, v, mesh, causal=True,
                                              local="flash"),
         d * (s_ranks + s_ranks * (s_ranks - 1) // 2), d * (s_ranks - 1)),
        ("ulysses_flash", lambda: ulysses_attention(
            q, k, v, mesh, causal=True, local="flash"),
         d * s_ranks, d * 4 * (s_ranks - 1)))
    for label, fn, flash, exchange in planes:
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = _counts()
        want = {"flash_fwd": flash, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "ring_exchange": exchange}
        check(counts == want, f"mesh_2d {label}: launches {counts}, want "
              f"{want}")
        check(tuple(out.shape) == (b, s, h, hd)
              and bool(torch.isfinite(out.float()).all()),
              f"mesh_2d {label}: shape or non-finite values")
        err = max((out[i].float() - refs[i].float()).abs().max().item()
                  for i in range(b))
        check(err < TOL[dt], f"mesh_2d {label}: max_abs_err {err} vs "
              f"single-device flash, tol {TOL[dt]}")
        runs[label] = {"launches": counts, "max_abs_err": err,
                       "tol": TOL[dt], "ms": cuda_ms(torch, fn, reps=3)}
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    del q, k, v, refs
    torch.cuda.empty_cache()
    emit({"phase": "mesh_2d", "card": card, "grid": list(GRID),
          "axes": ["data", "seq"], "shape": list(GRID_SHAPE),
          "causal": True, "single_device_flash_ms": single_ms,
          "runs": runs, "phase_seconds": time.perf_counter() - start})
    return launches


def phase_lm_mesh(torch):
    """The full-width TinyLM forward over RANKS ranks of the card, on the
    three mesh planes, against the single-device flash model (one weight
    tree): logits within LM_TOL, launches per forward, tokens/s. No
    gradient is needed, so the planes' default engine rotates through
    ``ring_exchange``: n - 1 launches a layer on the ring and flash
    planes, 4 (n - 1) on Ulysses."""
    from fiber_tpu_torch.models import convert
    from fiber_tpu_torch.models.transformer import TinyLM
    from fiber_tpu_torch.parallel.mesh import make_mesh

    n, seq = RANKS, LM_CFG["max_seq"]
    state = convert.tinylm_params_from_jax(
        convert.random_tinylm_tree(**LM_CFG, seed=0), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, LM_CFG["vocab"], (seq,), generator=g,
                           device="cuda")
    single = TinyLM(**LM_CFG, attention="flash", device="cuda")
    single.load_state_dict(state)
    ref = single.apply(tokens)
    del single
    layers = LM_CFG["layers"]
    flash = {"flash": layers * (n + n * (n - 1) // 2), "ring": 0,
             "ulysses": 0}
    exchange = {"flash": layers * (n - 1), "ring": layers * (n - 1),
                "ulysses": layers * 4 * (n - 1)}
    rows = {}
    for attention in ("flash", "ring", "ulysses"):
        model = TinyLM(**LM_CFG, attention=attention,
                       mesh=make_mesh("cuda", n=n))
        model.load_state_dict(state)
        model.apply(tokens)                   # warm-up, not counted
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        logits = model.apply(tokens)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
        want = {"flash_fwd": flash[attention], "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0, "ring_exchange": exchange[attention]}
        check(counts == want, f"lm_mesh {attention}: launches {counts}, "
              f"want {want}")
        check(tuple(logits.shape) == (seq, LM_CFG["vocab"])
              and bool(torch.isfinite(logits).all()),
              f"lm_mesh {attention}: shape or non-finite logits")
        err = (logits - ref).abs().max().item()
        check(err < LM_TOL, f"lm_mesh {attention}: logits differ from the "
              f"single-device flash model by {err}")
        rows[attention] = {"launches": counts, "seconds": secs,
                           "tokens_per_s": seq / secs,
                           "max_abs_err_vs_single_flash": err}
        del model, logits
        torch.cuda.empty_cache()
    emit({"phase": "lm_mesh", **LM_CFG, "ranks": n, "tol": LM_TOL,
          "planes": rows})


def phase_es_mesh(torch):
    """One flagship ES step over RANKS ranks of the card, with injected
    noise and initial states, against a plain recomputation: the
    gathered fitness is the returns of one rollout over every rank's
    members, rank-major (the step's own single ``eval_fn`` call, so the
    returns must agree bit for bit), ranks 0 and n - 1 rolled out alone
    give their own rows, and the gradient is the rank-shaped sum over
    that noise. Then ``run_fused`` over the mesh, held against
    eager steps as in the ``es`` phase."""
    from fiber_tpu_torch.entry import flagship_policy
    from fiber_tpu_torch.models.envs import CartPole
    from fiber_tpu_torch.ops.es import EvolutionStrategy
    from fiber_tpu_torch.parallel.mesh import make_mesh

    n, pop, steps, sigma = RANKS, 4096, 500, 0.1
    policy = flagship_policy()

    def rollout(thetas, states):
        return CartPole.rollout(policy.act, thetas, states, max_steps=steps)

    es = EvolutionStrategy(rollout, CartPole.reset, dim=policy.dim,
                           pop_size=pop, sigma=sigma, lr=0.03,
                           mesh=make_mesh("cuda", n=n))
    g = torch.Generator(device="cuda").manual_seed(4)
    eps = torch.randn(pop // 2, policy.dim, generator=g, device="cuda")
    states = CartPole.reset(pop, g)
    params = policy.init(torch.Generator().manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_params, stats = es.step(params, eps=eps, states=states)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0

    k = pop // (2 * n)
    e = eps.reshape(n, k, -1)
    thetas = torch.cat([params + sigma * e, params - sigma * e], dim=1)
    want_fit = rollout(thetas.reshape(pop, -1), states).reshape(n, 2 * k)
    check(torch.equal(es.last_fitness, want_fit),
          "gathered fitness is not the per-rank returns, rank-major")
    # The layout, independently of the step's own: a rollout of rank r's
    # members alone (its eps rows and its state rows, "+" then "-"). A
    # batch of another size may round the policy's products otherwise,
    # so a few integer returns may differ. Against another rank's row
    # the same rollout must differ in more, or the check sees nothing.
    own, per_rank = {}, {}
    for r in (0, n - 1):
        e_r = eps[r * k:(r + 1) * k]
        own[r] = rollout(
            torch.cat([params + sigma * e_r, params - sigma * e_r]),
            states[2 * r * k:2 * (r + 1) * k])
        per_rank[r] = int((own[r] != es.last_fitness[r]).sum())
        check(per_rank[r] <= ES_LAYOUT_MISMATCHES, f"rank {r}: "
              f"{per_rank[r]} of {2 * k} returns differ from a rollout of "
              f"its own members")
    other_rank = int((own[0] != es.last_fitness[n - 1]).sum())
    check(other_rank > ES_LAYOUT_MISMATCHES, f"rank 0's own rollout "
          f"differs from rank {n - 1}'s row in only {other_rank} returns")
    flat = want_fit.reshape(-1)
    ranks = torch.empty(pop, device="cuda")
    ranks[torch.argsort(flat, stable=True)] = torch.arange(
        pop, device="cuda", dtype=torch.float32)
    ranks = (ranks / (pop - 1) - 0.5).reshape(n, 2 * k)
    w = ranks[:, :k] - ranks[:, k:]
    grad = torch.einsum("rk,rkd->d", w, eps.reshape(n, k, -1)) / (
        pop * sigma)
    grad_err = (es.last_grad - grad).abs().max().item()
    check(grad_err < ES_RANK_TOL, f"gradient differs from a plain "
          f"recomputation by {grad_err}")
    check(bool(torch.isfinite(stats).all())
          and bool(torch.isfinite(new_params).all()),
          f"stats {stats.tolist()}")
    fused = _es_fused(torch, _flagship_es(torch, pop, steps, ranks=n),
                      ES_GENS)
    emit({"phase": "es_mesh", "ranks": n, "pop": pop, "max_steps": steps,
          "seconds": secs, "evals_per_s": pop / secs,
          "distinct_returns": len(set(flat.tolist())),
          "per_rank_rollout_mismatches": per_rank,
          "per_rank_mismatch_allowance": ES_LAYOUT_MISMATCHES,
          "rank0_rollout_vs_last_rank_row_mismatches": other_rank,
          "grad_max_abs_err": grad_err, "tol": ES_RANK_TOL,
          "max_abs_grad": grad.abs().max().item(), "stats": stats.tolist(),
          "fused": fused})


def _ring_layer_without_recompute(torch, tokens):
    """Peak memory of one loss and backward through a one-layer TinyLM
    at full width on the ring plane over RANKS ranks, with the plane's
    engine keeping its score slabs (``recompute=False``): the
    measurement behind the plane's recompute under grad."""
    from fiber_tpu_torch.models.transformer import TinyLM
    from fiber_tpu_torch.ops import ring_attention as ring
    from fiber_tpu_torch.parallel.mesh import make_mesh

    keep = ring._accumulate_block
    ring._accumulate_block = functools.partial(keep, recompute=False)
    try:
        model = TinyLM(**dict(LM_CFG, layers=1), attention="ring",
                       mesh=make_mesh("cuda", n=RANKS))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model.loss(tokens).backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    finally:
        ring._accumulate_block = keep
    del model
    torch.cuda.empty_cache()
    return peak


def phase_lm_mesh_train(torch):
    """TinyLM training at full width over RANKS ranks of the card, on the
    flash, ring and Ulysses planes. One weight tree
    (``random_tinylm_tree(seed=0)``): one step's loss within LM_TOL and
    every gradient leaf within GRAD_TOL of the single-device flash
    model's, beside the largest gradient, which scales the bound. Then
    the entry point, ``train_lm(attention=..., ranks=RANKS)``: one
    warm-up and TRAIN_STEPS AdamW steps, with a falling loss, the
    launches of that run (under grad the rotations take plain copies: no
    ``ring_exchange``; only the flash plane runs kernels, 10 blocks a
    layer forward and backward), tokens/s and peak memory; and one
    step's device time by CUDA events. Returns the flash plane's
    launches."""
    from fiber_tpu_torch.entry import train_lm
    from fiber_tpu_torch.models import convert
    from fiber_tpu_torch.models.transformer import (
        TinyLM,
        adamw,
        make_train_step,
    )
    from fiber_tpu_torch.parallel.mesh import make_mesh

    n, seq, layers = RANKS, LM_CFG["max_seq"], LM_CFG["layers"]
    state = convert.tinylm_params_from_jax(
        convert.random_tinylm_tree(**LM_CFG, seed=0), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, LM_CFG["vocab"], (seq,), generator=g,
                           device="cuda")

    def loss_and_grads(model):
        model.load_state_dict(state)
        loss = model.loss(tokens)
        loss.backward()
        grads = {k: p.grad for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    def max_abs(grads):
        return max(x.abs().max().item() for x in grads.values())

    single = TinyLM(**LM_CFG, attention="flash", device="cuda")
    ref_loss, ref_grads = loss_and_grads(single)
    ref_max_grad = max_abs(ref_grads)
    del single
    ring_layer_bytes = _ring_layer_without_recompute(torch, tokens)
    blocks = layers * (n + n * (n - 1) // 2)
    steps_run = TRAIN_STEPS + 1                  # the warm-up step too
    per_step = {"flash": {"flash_fwd": blocks, "flash_bwd_dq": blocks,
                          "flash_bwd_dkv": blocks, "ring_exchange": 0}}
    none = dict.fromkeys(per_step["flash"], 0)
    rows, flash_launches = {}, None
    for attention in ("flash", "ring", "ulysses"):
        model = TinyLM(**LM_CFG, attention=attention,
                       mesh=make_mesh("cuda", n=n))
        loss, grads = loss_and_grads(model)
        loss_err = abs(loss - ref_loss)
        grad_err = max((grads[k] - ref_grads[k]).abs().max().item()
                       for k in ref_grads)
        max_grad = max_abs(grads)
        del grads
        check(loss_err < LM_TOL, f"lm_mesh_train {attention}: loss differs "
              f"from the single-device flash model's by {loss_err}")
        check(grad_err < GRAD_TOL, f"lm_mesh_train {attention}: gradients "
              f"differ from the single-device flash model's by {grad_err}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        losses, secs = train_lm(device="cuda", seq=seq, steps=TRAIN_STEPS,
                                attention=attention, ranks=n)
        counts = _counts()
        peak_bytes = torch.cuda.max_memory_allocated()
        want = {k: v * steps_run
                for k, v in per_step.get(attention, none).items()}
        check(counts == want, f"lm_mesh_train {attention}: launches "
              f"{counts} in {steps_run} steps, want {want}")
        check(bool(torch.isfinite(losses).all()), f"lm_mesh_train "
              f"{attention}: losses {losses.tolist()}")
        check(float(losses[-1]) < float(losses[0]), f"lm_mesh_train "
              f"{attention}: loss did not fall: {losses.tolist()}")
        step = make_train_step(model, adamw(model.parameters(), 1e-3))
        step_ms = cuda_ms(torch, lambda: step(tokens), reps=2)
        rows[attention] = {
            "loss": loss, "loss_err_vs_single_flash": loss_err,
            "max_grad_err_vs_single_flash": grad_err,
            "max_abs_grad": max_grad,
            "losses": losses.tolist(), "seconds": secs,
            "tokens_per_s": seq * TRAIN_STEPS / secs, "step_ms": step_ms,
            "launches": counts,
            "launches_per_step": {k: v / steps_run
                                  for k, v in counts.items()},
            "peak_memory_bytes": peak_bytes}
        if attention == "flash":
            flash_launches = counts
        del model, step
        torch.cuda.empty_cache()
    emit({"phase": "lm_mesh_train", **LM_CFG, "ranks": n,
          "optimizer": "adamw(1e-3)", "steps": TRAIN_STEPS,
          "entry": "train_lm", "single_flash_loss": ref_loss,
          "single_flash_max_abs_grad": ref_max_grad, "loss_tol": LM_TOL,
          "grad_tol": GRAD_TOL, "planes": rows,
          "ring_one_layer_without_recompute_peak_bytes": ring_layer_bytes})
    return flash_launches


# -- the population-search families ------------------------------------

def _cartpole_family(torch, cls, pop, ranks=1, seed=1, **kw):
    """``cls`` (PGPE, SepCMAES or CMAES) on CartPole with the flagship's
    MLP (32, 32), FAMILY_STEPS-step episodes, over ``ranks`` ranks of the
    card, its generator seeded ``seed``; and its initial state from the
    flagship's initial params (seed 0), as ``es_cartpole.py --algo``
    builds it."""
    from fiber_tpu_torch.entry import flagship_policy
    from fiber_tpu_torch.models.envs import CartPole
    from fiber_tpu_torch.parallel.mesh import make_mesh

    policy = flagship_policy()
    algo = cls(lambda thetas, states: CartPole.rollout(
                   policy.act, thetas, states, max_steps=FAMILY_STEPS),
               CartPole.reset, dim=policy.dim, pop_size=pop,
               mesh=make_mesh("cuda", n=ranks),
               generator=torch.Generator(device="cuda").manual_seed(seed),
               **kw)
    params = policy.init(torch.Generator().manual_seed(0), device="cuda")
    return algo, algo.init_state(params)


def _generation_breakdown(torch, algo, gens):
    """The profiler's view of one captured generation of ``algo``: the
    graph replay, after the eager prep where the family has one."""
    runner = algo._fused_runner_cache[gens]

    def one():
        runner._run_prep()
        runner.graph.replay()

    return device_breakdown(torch, one), cuda_ms(torch, one, reps=3)


def _family_fused(torch, algo, state, gens, profile=False):
    """``run_fused`` over ``gens`` generations against as many eager
    ``step`` calls from the same state and generator state: stats
    exactly equal, every state leaf bitwise equal, the generator's state
    after both equal (else the run fails). Then evals/s of a timed
    ``run_fused`` after that warm one and of the eager steps; with
    ``profile``, the device busy time, span, idle share and launches of
    one eager generation and of one replayed generation."""
    gen0 = algo.generator.get_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused, fused_s = algo.run_fused(state, gens)      # captures, warm
    torch.cuda.synchronize()
    first_secs = time.perf_counter() - t0
    fused_gen = algo.generator.get_state()
    algo.generator.set_state(gen0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager, rows = algo.run(state, gens)
    torch.cuda.synchronize()
    eager_secs = time.perf_counter() - t0
    name = type(algo).__name__
    eager_s = torch.stack(rows)
    check(torch.equal(fused_s, eager_s), f"{name}: fused stats "
          f"{fused_s.tolist()} differ from eager {eager_s.tolist()}")
    for i, (a, b) in enumerate(zip(fused, eager)):
        check(torch.equal(_bits(torch, a.reshape(-1)),
                          _bits(torch, b.reshape(-1))),
              f"{name}: fused state slot {i} differs from eager by "
              f"{(a.double() - b.double()).abs().max().item()}")
    check(torch.equal(fused_gen, algo.generator.get_state()),
          f"{name}: the generator's state differs after the fused and "
          "eager runs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, stats = algo.run_fused(fused, gens)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(bool(torch.isfinite(stats).all()), f"{name}: stats "
          f"{stats.tolist()}")
    row = {"family": name, "ranks": algo.mesh.n_dev, "pop": algo.pop_size,
           "generations": gens, "stats_equal": True, "state_bitwise": True,
           "generator_state_equal": True,
           "eager_prep": algo._eager_prep is not None,
           "first_call_seconds": first_secs, "fused_seconds": secs,
           "fused_evals_per_s": gens * algo.pop_size / secs,
           "eager_seconds": eager_secs,
           "eager_evals_per_s": gens * algo.pop_size / eager_secs,
           "stats_first": stats[0].tolist(), "stats_last": stats[-1].tolist()}
    if profile:
        row["eager_generation"] = device_breakdown(
            torch, lambda: algo.step(again))
        row["replay"], row["replay_ms"] = _generation_breakdown(torch, algo,
                                                                gens)
    return row


def _family_mesh(torch, cls):
    """One step of ``cls`` over RANKS ranks of the card on injected
    draws, against a plain recomputation: SepCMAES against its one-rank
    step (its population has the same member order on any mesh: the
    returns are equal, the state within FAMILY_MESH_TOL, sums per rank
    and then over ranks); PGPE, whose antithetic halves are per rank,
    against mu's update recomputed from a rollout of the rank-major
    population (stats exact, mu within FAMILY_MESH_TOL). Then
    ``run_fused`` over the mesh against eager steps."""
    from fiber_tpu_torch.models.envs import CartPole
    from fiber_tpu_torch.ops.es import centered_rank

    n = RANKS
    algo, state = _cartpole_family(torch, cls, FAMILY_POP, ranks=n)
    g = torch.Generator(device="cuda").manual_seed(7)
    rows = algo.pairs if cls.__name__ == "PGPE" else algo.pop_size
    z = torch.randn(rows, algo.dim, generator=g, device="cuda")
    states = CartPole.reset(algo.pop_size, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, got_s = algo.step(state, z=z, states=states)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if cls.__name__ == "PGPE":
        mu, sigma = state
        k = algo.pairs_per_dev
        e = (sigma * z).reshape(n, k, -1)
        fit = algo.eval_fn(torch.cat([mu + e, mu - e], dim=1).reshape(
            algo.pop_size, -1), states)
        ranks = centered_rank(fit).reshape(n, 2 * k)
        want = mu + algo.lr_mu * torch.einsum(
            "rk,rkd->d", ranks[:, :k] - ranks[:, k:], e) / algo.pop_size
        want_s = torch.stack([fit.mean(), fit.max()])
        err = (got[0] - want).abs().max().item()
    else:
        one, _ = _cartpole_family(torch, cls, FAMILY_POP)
        want, want_s = one.step(state, z=z, states=states)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
    check(torch.equal(got_s[:2], want_s[:2]), f"{cls.__name__} over {n} "
          f"ranks: stats {got_s.tolist()} against {want_s.tolist()}")
    check(err <= FAMILY_MESH_TOL, f"{cls.__name__} over {n} ranks: the "
          f"state differs from the plain recomputation by {err}")
    fused = _family_fused(torch, algo, got, FAMILY_MESH_GENS)
    return {"ranks": n, "step_seconds": secs,
            "step_evals_per_s": algo.pop_size / secs,
            "max_abs_err_vs_plain": err, "tol": FAMILY_MESH_TOL,
            "fused": fused}


def _smooth_families(torch):
    """Every family's step on the card and on the CPU from the same
    state with the same draws, on the quadratic of the JAX package's
    fused-runner test at SMOOTH_DIM and SMOOTH_POP (a seeded target):
    every state leaf within SMOOTH_TOL. CMAES steps from C = I (both
    libraries factor I as I) and from a seeded C whose eigenvalues lie
    0.024 apart on [0.5, 2], and is held in three parts
    (``_smooth_cma``): the card's eigh within EIGH_TOL, the rest of the
    step on one factorisation within SMOOTH_TOL, and the whole step on
    the card's own eigh, its vectors aligned by sign, within
    CMA_OWN_EIGH_TOL. This holds the card's eigh, topk and
    scatter_reduce apart from the chaotic rollouts."""
    from fiber_tpu_torch.ops import (
        CMAES,
        PGPE,
        MAPElites,
        NoveltyES,
        SepCMAES,
    )

    dim, pop = SMOOTH_DIM, SMOOTH_POP
    g = torch.Generator().manual_seed(11)
    target = torch.rand(dim, generator=g) - 0.5
    start = 0.1 * torch.randn(dim, generator=g)
    basis, _ = torch.linalg.qr(torch.randn(dim, dim, generator=g))
    spread = basis @ torch.diag(torch.linspace(0.5, 2.0, dim)) @ basis.T

    def quadratic(thetas, states):
        return -((thetas - target.to(thetas.device)) ** 2).sum(1)

    def with_bc(thetas, states):
        return quadratic(thetas, states), thetas[:, :2]

    def no_states(n, gen=None):
        return torch.zeros(n, 1, device=gen.device if gen is not None
                           else "cpu")

    def to_card(state):
        leaves = [t.cuda() for t in state]
        return state._make(leaves) if hasattr(state, "_make") \
            else tuple(leaves)

    def build(dev):
        return {
            "PGPE": PGPE(quadratic, no_states, dim=dim, pop_size=pop,
                         device=dev),
            "SepCMAES": SepCMAES(quadratic, no_states, dim=dim,
                                 pop_size=pop, device=dev),
            "CMAES": CMAES(quadratic, no_states, dim=dim, pop_size=pop,
                           device=dev),
            "NoveltyES": NoveltyES(with_bc, no_states, dim=dim, bc_dim=2,
                                   pop_size=pop, archive_size=16, k=5,
                                   adaptive=True, device=dev),
            "MAPElites": MAPElites(with_bc, no_states, dim=dim, bc_dim=2,
                                   bc_low=(-1, -1), bc_high=(1, 1),
                                   cells_per_dim=8, batch_size=pop,
                                   sigma=0.2, device=dev)}

    def leaf_err(got, want):
        err = 0.0
        for x, y in zip(got, want):
            x, live = x.cpu(), torch.isfinite(y)
            check(torch.equal(torch.isfinite(x), live),
                  f"smooth: finite entries differ card vs CPU")
            if live.any():
                err = max(err, (x[live].double() - y[live].double()).abs()
                          .max().item())
        return err

    cpu, card = build("cpu"), build("cuda")
    rows, cma = {}, []
    for name in cpu:
        a, b = cpu[name], card[name]
        if name in ("NoveltyES", "MAPElites"):
            starts = [a.init_state(start, torch.zeros(1, 1))]
        else:
            starts = [a.init_state(start)]
        if name == "CMAES":
            starts.append(starts[0][:2] + (spread,) + starts[0][3:])
        err = 0.0
        for cs in starts:
            draws = {"states": torch.zeros(pop, 1)}
            if name == "MAPElites":
                draws["parent_cells"] = a._draw_parents(cs.fitness)
                draws["noise"] = torch.randn(pop, dim, generator=g)
            else:
                rows_ = a.pairs if hasattr(a, "pairs") else a.pop_size
                draws["eps" if name == "NoveltyES" else "z"] = torch.randn(
                    rows_, dim, generator=g)
            if name == "NoveltyES":
                draws["center_state"] = torch.zeros(1, 1)
            card_draws = {k: v.cuda() for k, v in draws.items()}
            gs = to_card(cs)
            want, _ = a.step(cs, **draws)
            if name != "CMAES":
                got, _ = b.step(gs, **card_draws)
                err = max(err, leaf_err(got, want))
                continue
            cma.append(_smooth_cma(torch, a, b, cs, gs, draws, card_draws,
                                   want, leaf_err))
        if name != "CMAES":
            rows[name] = err
    row = {"dim": dim, "pop": pop, "tol": SMOOTH_TOL, "eigh_tol": EIGH_TOL,
           "cma_own_eigh_tol": CMA_OWN_EIGH_TOL,
           "max_abs_err_card_vs_cpu": rows, "CMAES": cma}
    emit({"phase": "es_families_smooth", **row})
    for name, err in rows.items():
        check(err <= SMOOTH_TOL, f"smooth {name}: card and CPU differ by "
              f"{err}")
    for r in cma:
        check(max(r["eigenvalue_err"], r["residual"], r["orthogonality"])
              <= EIGH_TOL, f"smooth CMAES: the card's eigh: {r}")
        check(r["step_same_factorization_err"] <= SMOOTH_TOL,
              f"smooth CMAES: step on one factorization: {r}")
        check(r["step_own_eigh_err"] <= CMA_OWN_EIGH_TOL,
              f"smooth CMAES: step with the card's own eigh: {r}")
    return row


def _smooth_cma(torch, a, b, cs, gs, draws, card_draws, want, leaf_err):
    """CMAES on the card against the CPU from one state: the card's eigh
    of the symmetrised C (its eigenvalues against the CPU's, its own
    residual ``C B - B diag(lambda)`` and ``B^T B - I``, and its vectors
    against the CPU's after sign alignment); the rest of the step on the
    CPU's factorisation moved to the card; and the card's own step, with
    z times ``S = sign(diag(B_cpu^T B_card))``, which gives the same y
    and ``C^{-1/2} <y>_w`` where the vectors agree."""
    c_cpu = 0.5 * (cs[2] + cs[2].T)
    c_card = 0.5 * (gs[2] + gs[2].T)
    vals_cpu, b_cpu = torch.linalg.eigh(c_cpu)
    vals_card, b_card = torch.linalg.eigh(c_card)
    eye = torch.eye(c_card.shape[0], device="cuda")
    diag = torch.diagonal(b_cpu.T @ b_card.cpu())
    check(bool((diag.abs() > 0.99).all()), "smooth CMAES: the card's "
          "eigenvectors are not the CPU's up to sign")
    sign = torch.sign(diag)
    *same, _ = b._generation(*gs, card_draws["z"], card_draws["states"],
                             tuple(t.cuda() for t in a._prep_cov(cs[2])))
    own, _ = b.step(gs, z=card_draws["z"] * sign.cuda(),
                    states=card_draws["states"])
    return {
        "eigenvalue_err": (vals_card.cpu() - vals_cpu).abs().max().item(),
        "residual": (c_card @ b_card - b_card * vals_card).abs().max()
        .item(),
        "orthogonality": (b_card.T @ b_card - eye).abs().max().item(),
        "eigenvector_err_after_sign": (b_card.cpu() * sign - b_cpu).abs()
        .max().item(),
        "step_same_factorization_err": leaf_err(same, want),
        "step_own_eigh_err": leaf_err(own, want)}


def phase_es_families(torch):
    """PGPE and SepCMAES at the flagship's population (es_cartpole.py
    --algo pgpe|cma at bench.py's pop 4096): one eager step, then
    ``run_fused`` against eager steps (``_family_fused``) with the
    profiler's view of a generation, and the same over RANKS ranks.
    CMAES at es_cartpole.py --algo fullcma's defaults (pop 1024, a
    (1282, 1282) covariance): the ms of one eigh, the capture decision
    (an eager eigh before each replay of the captured remainder), and
    ``run_fused`` against eager steps. Then every family on the card
    against the CPU on a smooth objective (its own line,
    ``es_families_smooth``)."""
    from fiber_tpu_torch.ops import CMAES, PGPE, SepCMAES

    rows = {}
    for cls in (PGPE, SepCMAES):
        algo, state = _cartpole_family(torch, cls, FAMILY_POP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stats = algo.step(state)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        check(bool(torch.isfinite(stats).all()), f"{cls.__name__} stats "
              f"{stats.tolist()}")
        row = _family_fused(torch, algo, state, FAMILY_GENS, profile=True)
        row.update(first_step_seconds=first, mesh=_family_mesh(torch, cls))
        rows[cls.__name__] = row
        del algo, state
        torch.cuda.empty_cache()

    cma, state = _cartpole_family(torch, CMAES, CMA_POP)
    check(cma._eager_prep is not None, "CMAES does not declare its eigh "
          "as eager prep")
    c = state[2] + 0.01 * torch.randn(
        state[2].shape, generator=torch.Generator(device="cuda").manual_seed(
            3), device="cuda")
    c = c @ c.T
    eigh_ms = cuda_ms(torch, lambda: torch.linalg.eigh(c), reps=5)
    row = _family_fused(torch, cma, state, CMA_GENS, profile=True)
    row.update(dim=cma.dim, covariance=list(state[2].shape),
               eigh_ms=eigh_ms,
               capture="eager eigh before each replay of the captured "
                       "remainder (torch.linalg.eigh checks its info on "
                       "the host, which a capture refuses)")
    rows["CMAES"] = row
    del cma, state
    torch.cuda.empty_cache()
    emit({"phase": "es_families", "pop": FAMILY_POP,
          "max_steps": FAMILY_STEPS, "hidden": [32, 32], "families": rows})
    _smooth_families(torch)


def _maze_eval(policy):
    from fiber_tpu_torch.models.envs import DeceptiveMaze

    def eval_bc(thetas, states):
        return DeceptiveMaze.fitness_and_behavior(policy.apply, thetas,
                                                  states)

    return eval_bc


def phase_novelty(torch):
    """NoveltyES at novelty_maze.py's settings (DeceptiveMaze, MLP (16,),
    pop 256, archive 128, k 10, sigma 0.1, lr 0.05) in each of its three
    modes: NOVELTY_GENS eager steps, the archive's count 1 + generations
    and ``best`` never falling; then ``run_fused`` from the same start
    against those steps (stats and state bitwise). Then one generation
    at pop NOVELTY_RATE_POP, eager and replayed, for the rate."""
    from fiber_tpu_torch.models.envs import DeceptiveMaze
    from fiber_tpu_torch.models.policies import MLPPolicy
    from fiber_tpu_torch.ops import NoveltyES

    policy = MLPPolicy(DeceptiveMaze.obs_dim, DeceptiveMaze.act_dim,
                       hidden=(16,))
    p0 = policy.init(torch.Generator().manual_seed(0), device="cuda")

    def make(pop, w, adaptive):
        return NoveltyES(_maze_eval(policy), DeceptiveMaze.reset,
                         dim=policy.dim, bc_dim=2, pop_size=pop, sigma=0.1,
                         lr=0.05, archive_size=128, k=10, reward_weight=w,
                         adaptive=adaptive, weight_delta=0.1, patience=5,
                         device="cuda",
                         generator=torch.Generator(
                             device="cuda").manual_seed(2))

    modes = {}
    for label, w, adaptive in NOVELTY_MODES:
        nes = make(NOVELTY_POP, w, adaptive)
        state0 = nes.init_state(p0)
        gen0 = nes.generator.get_state()
        state, bests, best_gen, rows = state0, [], -float("inf"), []
        for _ in range(NOVELTY_GENS):
            state, stats = nes.step(state)
            rows.append(stats)
            bests.append(float(state.best))
            best_gen = max(best_gen, float(stats[1]))
        check(int(state.count) == 1 + NOVELTY_GENS, f"novelty {label}: "
              f"count {int(state.count)} after {NOVELTY_GENS} generations")
        check(bests == sorted(bests) and bests[-1] == best_gen,
              f"novelty {label}: best fell: {bests}")
        eager_gen = nes.generator.get_state()
        nes.generator.set_state(gen0)
        fused, fused_s = nes.run_fused(state0, NOVELTY_GENS)
        check(all(torch.equal(_bits(torch, a.reshape(-1)),
                              _bits(torch, b.reshape(-1)))
                  for a, b in zip(fused, state))
              and torch.equal(fused_s, torch.stack(rows))
              and torch.equal(nes.generator.get_state(), eager_gen),
              f"novelty {label}: run_fused differs from eager steps")
        modes[label] = {"best": bests[-1], "final_w": float(state.w),
                        "count": int(state.count),
                        "archive_max_y": float(state.archive[:, 1].max()),
                        "fused_equal_eager": True}
    nes = make(NOVELTY_RATE_POP, 0.5, False)
    state = nes.init_state(p0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = nes.step(state)
    torch.cuda.synchronize()
    eager_secs = time.perf_counter() - t0
    state, _ = nes.run_fused(state, 1)
    replay, replay_ms = _generation_breakdown(torch, nes, 1)
    emit({"phase": "novelty", "pop": NOVELTY_POP, "archive": 128, "k": 10,
          "generations": NOVELTY_GENS, "hidden": [16], "modes": modes,
          "rate_pop": NOVELTY_RATE_POP, "eager_generation_seconds":
          eager_secs, "eager_evals_per_s": NOVELTY_RATE_POP / eager_secs,
          "replay_ms": replay_ms,
          "replay_evals_per_s": NOVELTY_RATE_POP / replay_ms * 1e3,
          "replay": replay})


def phase_map_elites(torch):
    """MAPElites at map_elites_maze.py's settings (DeceptiveMaze, MLP
    (16,), 12 x 12 cells over [-4, 4]^2, batch 256, sigma 0.2) for
    MAP_ELITES_GENS generations: coverage and the best fitness never
    fall, no elite regresses in its cell, and every elite's behavior
    maps back to its cell. Then one generation at batch
    MAP_ELITES_RATE_BATCH for the rate, with the profiler's view."""
    from fiber_tpu_torch.models.envs import DeceptiveMaze
    from fiber_tpu_torch.models.policies import MLPPolicy
    from fiber_tpu_torch.ops import MAPElites

    policy = MLPPolicy(DeceptiveMaze.obs_dim, DeceptiveMaze.act_dim,
                       hidden=(16,))

    def make(batch):
        return MAPElites(_maze_eval(policy), DeceptiveMaze.reset,
                         dim=policy.dim, bc_dim=2, bc_low=(-4.0, -4.0),
                         bc_high=(4.0, 4.0), cells_per_dim=12,
                         batch_size=batch, sigma=0.2, device="cuda",
                         generator=torch.Generator(
                             device="cuda").manual_seed(1))

    me = make(MAP_ELITES_BATCH)
    state = me.init_state(policy.init(torch.Generator().manual_seed(0),
                                      device="cuda"))
    prev_fit, prev_cov, prev_best = state.fitness, 0.0, -float("inf")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for gen in range(MAP_ELITES_GENS):
        state, stats = me.step(state)
        kept = torch.isfinite(prev_fit)
        check(bool((state.fitness[kept] >= prev_fit[kept]).all()),
              f"map_elites generation {gen}: an elite regressed")
        cov, best = float(stats[1]), float(stats[2])
        check(cov >= prev_cov and best >= prev_best, f"map_elites "
              f"generation {gen}: coverage {cov} or best {best} fell")
        prev_fit, prev_cov, prev_best = state.fitness, cov, best
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    elites = me.elites(state)
    check(len(elites) == int(torch.isfinite(state.fitness).sum()),
          "map_elites: elites() misses filled cells")
    bcs = torch.stack([torch.from_numpy(bc) for _, _, bc, _ in elites])
    check(me._cell_of(bcs.cuda()).tolist() == [c for c, *_ in elites],
          "map_elites: an elite's behavior is not in its cell")
    beyond = int(((state.behaviors[:, 1] > 1.0)
                  & torch.isfinite(state.fitness)).sum())
    big = make(MAP_ELITES_RATE_BATCH)
    big_state = big.init_state(policy.init(torch.Generator().manual_seed(0),
                                           device="cuda"))
    big.step(big_state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big.step(big_state)
    torch.cuda.synchronize()
    rate_secs = time.perf_counter() - t0
    emit({"phase": "map_elites", "batch": MAP_ELITES_BATCH, "cells": 144,
          "generations": MAP_ELITES_GENS, "seconds": secs,
          "evals_per_s": MAP_ELITES_GENS * MAP_ELITES_BATCH / secs,
          "coverage": prev_cov, "best_fitness": prev_best, "qd":
          float(stats[0]), "cells_beyond_wall": beyond,
          "rate_batch": MAP_ELITES_RATE_BATCH,
          "rate_generation_seconds": rate_secs,
          "rate_evals_per_s": MAP_ELITES_RATE_BATCH / rate_secs,
          "generation": device_breakdown(
              torch, lambda: big.step(big_state))})


def simulate_cartpole(theta) -> float:
    """es_pool_gym.py's host evaluator: pure-Python CartPole with a
    linear policy, 200 steps from a fixed start."""
    import math
    import random

    rng = random.Random(12345)
    x, v, a, w = [0.02 * (rng.random() - 0.5) for _ in range(4)]
    g, mc, mp_, lp, dt = 9.8, 1.0, 0.1, 0.5, 0.02
    steps = 0
    for _ in range(200):
        obs = (x, v, a, w)
        score = sum(t * o for t, o in zip(theta, obs))
        force = 10.0 if score > 0 else -10.0
        cosa, sina = math.cos(a), math.sin(a)
        tmp = (force + mp_ * lp * w * w * sina) / (mc + mp_)
        aacc = (g * sina - cosa * tmp) / (
            lp * (4.0 / 3.0 - mp_ * cosa * cosa / (mc + mp_)))
        xacc = tmp - mp_ * lp * aacc * cosa / (mc + mp_)
        x, v = x + dt * v, v + dt * xacc
        a, w = a + dt * w, w + dt * aacc
        steps += 1
        if abs(x) > 2.4 or abs(a) > 0.209:
            break
    return float(steps)


def phase_ask_tell(torch):
    """es_pool_gym.py's loop (dim 4, pop 64, sigma 0.5, lr 0.3) with its
    host CartPole evaluator, sampling and updating on the card: the mean
    fitness rises. Then the ms of one ask and one tell at pop
    ASK_TELL_POP x the flagship's dim (host clock around synchronised
    work; ask includes copying the candidates to the host)."""
    from fiber_tpu_torch.entry import flagship_policy
    from fiber_tpu_torch.ops import AskTellES

    es = AskTellES(dim=4, pop_size=64, sigma=0.5, lr=0.3, device="cuda")
    means = []
    for _ in range(ASK_TELL_GENS):
        thetas = es.ask()
        means.append(es.tell([simulate_cartpole(t) for t in thetas.tolist()])
                     ["mean_fitness"])
    final = simulate_cartpole(es.params.tolist())
    check(means[-1] > means[0], f"ask_tell: mean fitness did not rise: "
          f"{means}")
    dim = flagship_policy().dim
    big = AskTellES(dim=dim, pop_size=ASK_TELL_POP, device="cuda")
    fits = torch.randn(ASK_TELL_POP,
                       generator=torch.Generator().manual_seed(0)).numpy()
    big.ask()                                             # warm
    big.tell(fits)
    ask_s, tell_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        thetas = big.ask()
        t1 = time.perf_counter()
        big.tell(fits)
        torch.cuda.synchronize()
        ask_s.append(t1 - t0)
        tell_s.append(time.perf_counter() - t1)
    check(thetas.shape == (ASK_TELL_POP, dim), f"ask shape {thetas.shape}")
    emit({"phase": "ask_tell", "dim": 4, "pop": 64, "generations":
          ASK_TELL_GENS, "mean_fitness": means, "final_policy_steps": final,
          "big_pop": ASK_TELL_POP, "big_dim": dim,
          "ask_ms": 1e3 * min(ask_s), "tell_ms": 1e3 * min(tell_s)})


def phase_device_map(torch):
    """``device_map`` of a per-item CartPole evaluation over
    DMAP_ITEMS (theta, state) pairs at the flagship's MLP (32, 32) and
    500 steps, on 1 and RANKS ranks of the card: the returns of
    ``EvolutionStrategy``'s batched evaluation of the same rows, exactly
    (the same batched products under vmap); evals/s of a warm call."""
    from fiber_tpu_torch.entry import flagship_policy
    from fiber_tpu_torch.models.envs import CartPole
    from fiber_tpu_torch.ops import EvolutionStrategy
    from fiber_tpu_torch.parallel import DeviceMapPlan
    from fiber_tpu_torch.parallel.mesh import make_mesh

    policy = flagship_policy()
    g = torch.Generator(device="cuda").manual_seed(9)
    params = policy.init(torch.Generator().manual_seed(0), device="cuda")
    thetas = params + 0.1 * torch.randn(DMAP_ITEMS, policy.dim,
                                        generator=g, device="cuda")
    states = CartPole.reset(DMAP_ITEMS, g)
    es = EvolutionStrategy(
        lambda th, st: CartPole.rollout(policy.act, th, st,
                                        max_steps=FAMILY_STEPS),
        CartPole.reset, dim=policy.dim, pop_size=DMAP_ITEMS, device="cuda")
    want = es.eval_fn(thetas, states).cpu()

    def evaluate(theta, state):
        return CartPole.rollout(policy.act, theta[None], state[None],
                                max_steps=FAMILY_STEPS)[0]

    items = list(zip(thetas, states))
    rows = {}
    for n in (1, RANKS):
        plan = DeviceMapPlan(evaluate, mesh=make_mesh("cuda", n=n),
                             star=True)
        got = plan(items)
        check([float(x) for x in got] == want.tolist(), f"device_map over "
              f"{n} ranks: returns differ from the batched evaluation")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan(items)
        secs = time.perf_counter() - t0
        rows[n] = {"seconds": secs, "evals_per_s": DMAP_ITEMS / secs}
    emit({"phase": "device_map", "items": DMAP_ITEMS, "hidden": [32, 32],
          "max_steps": FAMILY_STEPS, "equal_batched": True,
          "distinct_returns": len(set(want.tolist())), "ranks": rows})


# -- the user API: Pool, @meta(device=True) and host workers on the card ----

#: the package this one ports, whose modules a port worker must not load
#: (derived, so that no string here names one of its modules)
JAX_PACKAGE = "fiber_tpu_torch".removesuffix("_torch")
#: what a pickle stream may not hold: shared-memory and CUDA IPC handles
IPC_REBUILDERS = ("rebuild_storage_fd", "rebuild_storage_filename",
                  "rebuild_cuda_tensor", "DupFd", "rebuild_event")


def _stream_words(blob):
    """Every opcode argument of a serialized payload, as one string."""
    import pickletools

    from fiber_tpu_torch import serialization

    head = (serialization.unpack_envelope(blob)[0]
            if serialization.is_envelope(blob) else blob)
    return " ".join(str(arg) for _, arg, _ in pickletools.genops(bytes(head)))


def _pool_ping(_):
    """A host worker's first task: its pid, with no torch loaded."""
    return os.getpid(), "torch" in sys.modules


def _pool_tensor_task(t, k):
    """A host worker's tensor task: ``t * 2 + k`` on the device ``t``
    came on, the device type it saw, what of JAX or the JAX package the
    worker has loaded, and whether the result's stream holds an IPC
    handle."""
    from fiber_tpu_torch import serialization

    out = t * 2 + k
    leaky = any(word in _stream_words(serialization.dumps(out))
                for word in IPC_REBUILDERS)
    seen = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", JAX_PACKAGE))
    return out, t.device.type, seen, leaky


def _pool_evaluator(policy):
    """A per-item CartPole evaluation marked for the device, with its
    analytic FLOPs per item."""
    import fiber_tpu_torch
    from fiber_tpu_torch.models.envs import CartPole
    from fiber_tpu_torch.utils import flops

    @fiber_tpu_torch.meta(device=True, flops=flops.rollout_flops_per_eval(
        policy, "CartPole", FAMILY_STEPS))
    def evaluate(theta, state):
        return CartPole.rollout(policy.act, theta[None], state[None],
                                max_steps=FAMILY_STEPS)[0]

    return evaluate


def _pool_device_maps(torch):
    """The device route of the pool: returns equal to a direct
    ``DeviceMapPlan`` call, no worker, the shared parameters through the
    device tier once, the transfers and MFU in the telemetry."""
    import numpy as np

    import fiber_tpu_torch
    from fiber_tpu_torch import store as storemod
    from fiber_tpu_torch import telemetry
    from fiber_tpu_torch.entry import flagship_policy
    from fiber_tpu_torch.models.envs import CartPole
    from fiber_tpu_torch.models.policies import MLPPolicy
    from fiber_tpu_torch.parallel import DeviceMapPlan
    from fiber_tpu_torch.telemetry.device import DEVICE

    fiber_tpu_torch.init()
    DEVICE.clear()
    tier = storemod.device_store_tier()
    check(tier is not None, "the device tier is off")
    tier.clear()
    g = torch.Generator(device="cuda").manual_seed(11)
    rows = {}
    with fiber_tpu_torch.Pool(POOL_DEVICE_WORKERS) as pool:
        # the flagship: every item its own theta, on the card already
        policy = flagship_policy()
        params = policy.init(torch.Generator().manual_seed(0),
                             device="cuda")
        thetas = params + 0.1 * torch.randn(DMAP_ITEMS, policy.dim,
                                            generator=g, device="cuda")
        states = CartPole.reset(DMAP_ITEMS, g)
        evaluate = _pool_evaluator(policy)
        items = list(zip(thetas, states))
        plan = DeviceMapPlan(evaluate, star=True, device="cuda")
        rows["flagship"] = _pool_route_vs_plan(
            torch, pool, evaluate, items, lambda: plan(items), tier)
        # the wide MLP: one shared numpy parameter vector, host states
        wide = MLPPolicy(CartPole.obs_dim, CartPole.act_dim,
                         hidden=POOL_WIDE_HIDDEN)
        shared = (wide.init(torch.Generator().manual_seed(1), device="cpu")
                  .numpy())
        check(shared.nbytes >= 64 << 10, f"shared {shared.nbytes} B is "
              "under the pool's 64 KB broadcast floor")
        # start states four times as wide as CartPole.reset's, so that
        # one policy's episodes end at many different steps
        host_states = np.random.default_rng(12).uniform(
            -0.2, 0.2, (DMAP_ITEMS, 4)).astype(np.float32)
        evaluate_wide = _pool_evaluator(wide)
        wide_items = [(shared, s) for s in host_states]
        wide_plan = DeviceMapPlan(evaluate_wide, star=True, device="cuda",
                                  broadcast=(shared,),
                                  broadcast_positions=(0,))
        tier.clear()
        DEVICE.clear()
        rows["wide"] = _pool_route_vs_plan(
            torch, pool, evaluate_wide, wide_items,
            lambda: wide_plan([(s,) for s in host_states]), tier)
        DEVICE.update_gauges()
        snap = DEVICE.snapshot()
        children = fiber_tpu_torch.active_children()
    check(children == [], f"a device map started workers: {children}")
    for name, want_puts in (("flagship", 0), ("wide", 1)):
        got = rows[name]["tier_after_repeats"]
        check(got["puts"] == want_puts and got["put_dedup_hits"]
              == want_puts * (POOL_REPEATS - 1),
              f"{name}: tier after {POOL_REPEATS} maps: {got}")
    # POOL_REPEATS + 2 pool maps of the wide case (warm-up and timed ones)
    # and 3 direct plan calls, each moving its items' states to the card
    dmap_bytes = snap["transfers"].get("dmap", {}).get("bytes")
    pool_maps = rows["wide"]["pool_maps"]
    want = (pool_maps + rows["wide"]["plan_calls"]) * host_states.nbytes
    check(dmap_bytes == want, f"dmap bytes {dmap_bytes}, want {want}")
    check(snap["transfers"]["ici"]["bytes"] == shared.nbytes,
          f"ici {snap['transfers']['ici']} for one {shared.nbytes} B put")
    hbm = snap["hbm"]
    check(hbm["bytes_in_use"] and hbm["bytes_limit"]
          and snap["platform"] == "gpu", f"DEVICE snapshot: {hbm}, "
          f"{snap['platform']}")
    mfu = snap["mfu"]["mfu"]
    gauge = telemetry.REGISTRY.snapshot()["pool_map_mfu"]["series"]
    check(mfu is not None and mfu > 0 and gauge.get("") == mfu,
          f"pool_map_mfu {gauge}, DEVICE mfu {mfu}")
    return {"rows": rows, "workers_started": 0,
            "transfers": snap["transfers"], "hbm": hbm, "mfu": mfu,
            "peak_row": snap["mfu"]["peak_row"],
            "shared_bytes": int(shared.nbytes)}


def _pool_route_vs_plan(torch, pool, fn, items, direct, tier):
    """Pool route against the direct plan: the returns exactly, the
    device tier's counts after POOL_REPEATS pool maps, then evals/s of
    each route, timed in turns (plan, pool, pool, plan)."""
    want = [float(x) for x in direct()]
    check(len(set(want)) > 3, f"only {len(set(want))} distinct returns")
    for _ in range(POOL_REPEATS):
        got = pool.starmap(fn, items)
        check([float(x) for x in got] == want, "a pool-routed device map "
              "differs from the direct plan")
    stats = tier.stats()
    secs = {"plan": [], "pool": []}
    for route in ("plan", "pool", "pool", "plan"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = direct() if route == "plan" else pool.starmap(fn, items)
        secs[route].append(time.perf_counter() - t0)
        check([float(x) for x in out] == want, f"{route} route changed")
    return {"items": len(items), "equal_direct_plan": True,
            "distinct_returns": len(set(want)),
            "tier_after_repeats": {k: stats[k] for k in (
                "puts", "put_dedup_hits", "entries", "bytes")},
            "pool_maps": POOL_REPEATS + 2, "plan_calls": 3,
            "pool_evals_per_s": len(items) / min(secs["pool"]),
            "plan_evals_per_s": len(items) / min(secs["plan"]),
            "pool_seconds": secs["pool"], "plan_seconds": secs["plan"]}


def _pool_host_workers(torch):
    """Host workers on the card: a CUDA tensor argument in, a CUDA
    tensor out, equal to the master's computation; no IPC handle in
    either stream; no JAX and no JAX package in the workers."""
    import fiber_tpu_torch
    from fiber_tpu_torch import serialization

    t = torch.randn(POOL_TENSOR_MB << 18, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(13))
    check(not any(w in _stream_words(serialization.dumps((t, 1)))
                  for w in IPC_REBUILDERS), "a CUDA tensor's stream holds "
          "an IPC handle")
    items = [(t, k) for k in range(POOL_TENSOR_ITEMS)]
    t0 = time.perf_counter()
    with fiber_tpu_torch.Pool(POOL_HOST_WORKERS) as pool:
        pings = pool.map(_pool_ping, range(POOL_HOST_WORKERS), chunksize=1)
        start_s = time.perf_counter() - t0
        check(not any(loaded for _, loaded in pings),
              "a host worker loaded torch for a task that needs none")
        t1 = time.perf_counter()
        first = pool.starmap(_pool_tensor_task, items, chunksize=1)
        first_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        outs = pool.starmap(_pool_tensor_task, items, chunksize=1)
        warm_s = time.perf_counter() - t2
    deadline = time.monotonic() + 15
    while fiber_tpu_torch.active_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    check(fiber_tpu_torch.active_children() == [], "host workers outlived "
          "their pool")
    for (t_in, k), (out, where, seen, leaky) in zip(items, first + outs):
        check(out.device.type == "cuda" and where == "cuda",
              f"a tensor left the card: {out.device}, worker saw {where}")
        check(torch.equal(out, t_in * 2 + k), "a worker's result differs "
              "from the master's")
        check(seen == [], f"a worker loaded {seen}")
        check(not leaky, "a worker's result stream holds an IPC handle")
    moved = 2 * t.nbytes * len(items)
    return {"workers": POOL_HOST_WORKERS, "tensor_mb": POOL_TENSOR_MB,
            "items": len(items), "worker_start_s": start_s,
            "first_tensor_map_s": first_s, "warm_tensor_map_s": warm_s,
            "round_trip_mb_per_s": moved / 2**20 / warm_s,
            "equal_master": True, "ipc_handles": 0,
            "worker_jax_modules": []}


def phase_pool(torch):
    """The user API on the card, with every kernel's launch count set to
    0 before it and required to stay 0: a @meta(device=True) CartPole
    evaluation through ``Pool.starmap`` (the flagship MLP, and a wide one
    whose parameters ride the device tier), and host workers passing
    CUDA tensors."""
    start = time.perf_counter()
    _reset_counts()
    device = _pool_device_maps(torch)
    host = _pool_host_workers(torch)
    counts = _counts()
    check(not any(counts.values()), f"kernels launched on the pool paths: "
          f"{counts}")
    emit({"phase": "pool", "device_map": device, "host_workers": host,
          "launches": counts, "phase_seconds": time.perf_counter() - start})
    return counts


# -- the managers, the ring and the Pool-driven POET on the card ------------

def phase_managers(torch):
    """A managed dict round-trips a CUDA tensor: by value through the
    manager's server, back on the card, equal."""
    import fiber_tpu_torch

    t = torch.randn(MANAGER_TENSOR_MB << 18, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(21))
    t0 = time.perf_counter()
    manager = fiber_tpu_torch.Manager()
    start_s = time.perf_counter() - t0
    try:
        d = manager.dict()
        t1 = time.perf_counter()
        d["t"] = t
        put_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        back = d["t"]
        get_s = time.perf_counter() - t2
        t3 = time.perf_counter()
        again = d["t"]
        warm_get_s = time.perf_counter() - t3
    finally:
        manager.shutdown()
    for got in (back, again):
        check(got.device.type == "cuda" and got.dtype == t.dtype,
              f"a managed tensor came back on {got.device}, {got.dtype}")
        check(torch.equal(got, t), "a managed CUDA tensor came back "
              "changed")
    row = {"tensor_mb": MANAGER_TENSOR_MB, "manager_start_s": start_s,
           "first_put_s": put_s, "first_get_s": get_s,
           "warm_get_s": warm_get_s,
           "warm_get_mb_per_s": t.nbytes / 2**20 / warm_get_s,
           "device": str(back.device), "equal": True}
    emit({"phase": "managers", **row})
    return row


def _host_ring_rank(rank, size, results):
    """A ring rank: HOST_RING_REPS timed allreduces of an HOST_RING_MB
    MB f32 CUDA tensor of integer values (so that the sum is exact),
    after one warm-up. Its report holds numpy arrays, not tensors, so
    that the manager's server need not import torch to keep it."""
    entered = time.time()
    # the rank's process reached its ring without torch (light root)
    torch_at_entry = "torch" in sys.modules
    import torch

    from fiber_tpu_torch.parallel.ring import current_ring

    ring = current_ring()
    g = torch.Generator(device="cuda").manual_seed(30 + rank)
    t = torch.randint(-1000, 1000, (HOST_RING_MB << 18,), generator=g,
                      device="cuda").float()
    mine = t.clone()
    ring.allreduce(t)
    secs, outs = [], []
    for _ in range(HOST_RING_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ring.allreduce(t)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(out)
    ring.barrier()
    ring.close()
    first = outs[0]
    results[rank] = {
        "entered": entered, "torch_at_entry": torch_at_entry,
        "secs": secs, "device": str(first.device),
        "dtype": str(first.dtype),
        "same_every_time": all(torch.equal(o, first) for o in outs),
        "input_untouched": torch.equal(t, mine),
        "out": first.cpu().numpy(), "done": time.time()}


def phase_host_ring(torch):
    """``Ring(RING_RANKS)`` with the default initializer: every rank's
    allreduce equals the sum of the ranks' tensors, on ``cuda``."""
    import fiber_tpu_torch
    from fiber_tpu_torch.parallel import Ring

    manager = fiber_tpu_torch.Manager()
    try:
        results = manager.dict()
        t0 = time.time()
        Ring(RING_RANKS, functools.partial(_host_ring_rank,
                                           results=results)).run()
        ring_s = time.time() - t0
        got = {r: results[r] for r in range(RING_RANKS)}
    finally:
        manager.shutdown()
    want = sum(torch.randint(-1000, 1000, (HOST_RING_MB << 18,),
                             generator=torch.Generator(
                                 device="cuda").manual_seed(30 + r),
                             device="cuda").float()
               for r in range(RING_RANKS)).cpu()
    for r, row in got.items():
        check(row["device"].startswith("cuda") and row["dtype"]
              == "torch.float32", f"rank {r}: {row['device']} {row['dtype']}")
        check(not row["torch_at_entry"], f"rank {r} had torch loaded "
              "before its function ran")
        check(row["same_every_time"] and row["input_untouched"],
              f"rank {r}: allreduce results vary or the input changed")
        check(torch.equal(torch.from_numpy(row["out"]), want),
              f"rank {r}: allreduce is not the sum of the ranks' tensors")
    secs = [s for row in got.values() for s in row["secs"]]
    mb = HOST_RING_MB << 20
    out = {"ranks": RING_RANKS, "tensor_mb": HOST_RING_MB,
           "reps": HOST_RING_REPS, "allreduce_s": secs,
           "mb_per_s": mb / 2**20 / (sum(secs) / len(secs)),
           "best_mb_per_s": mb / 2**20 / min(secs),
           "rank_start_s": [got[r]["entered"] - t0
                            for r in range(RING_RANKS)],
           "rank_done_s": [got[r]["done"] - t0 for r in range(RING_RANKS)],
           "ring_run_s": ring_s, "equal_sum": True}
    emit({"phase": "host_ring", **out})
    return out


def _ring_es_rank(rank, size, results):
    """A gloo rank: the flagship ES over the process mesh for
    RING_ES_GENS eager generations, each generation's input params and
    gathered fitness kept (as numpy) for the master's check."""
    import torch
    import torch.distributed as dist

    from fiber_tpu_torch.examples.pod_es_ring import (flagship_es,
                                                      params_spread)
    from fiber_tpu_torch.parallel.mesh import make_mesh

    entered = time.time()
    try:
        mesh = make_mesh("cuda", group=dist.group.WORLD)
        es, params = flagship_es(mesh, 4096, 500)
        # gloo's broadcast takes a CUDA tensor as it is (its all_gather
        # and all_reduce do in every step): rank 0's initial params must
        # equal every rank's own, drawn from the same seed
        start = params.clone()
        dist.broadcast(start, 0)
        same_start = start.is_cuda and torch.equal(start, params)
        params_in, fitness, stats = [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RING_ES_GENS):
            params_in.append(params.cpu().numpy())
            params, st = es.step(params)
            fitness.append(es.last_fitness.cpu().numpy())
            stats.append(st.cpu().numpy())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        results[rank] = {
            "entered": entered, "secs": secs, "params_in": params_in,
            "fitness": fitness, "stats": stats,
            "params": params.cpu().numpy(), "device": str(params.device),
            "mesh": (mesh.n_dev, mesh.rank), "same_start": same_start,
            "spread": params_spread(params, mesh), "pop": es.pop_size,
            "done": time.time()}
    finally:
        dist.destroy_process_group()


def phase_ring_es(torch):
    """``Ring(RING_RANKS, torch_distributed_initializer)``: the flagship
    ES across processes. The params are replicated; each generation,
    from the ranks' input params and the same draws, the single-process
    mesh of RING_RANKS ranks on the card gives every rank's fitness row
    within ES_LAYOUT_MISMATCHES returns (a rank rolls out 2048 members
    where the single process rolls out 4096 in one call) and, where
    every return agrees, the same params bit for bit."""
    import numpy as np

    import fiber_tpu_torch
    from fiber_tpu_torch.examples.pod_es_ring import flagship_es
    from fiber_tpu_torch.parallel import Ring
    from fiber_tpu_torch.parallel.mesh import make_mesh
    from fiber_tpu_torch.parallel.ring import torch_distributed_initializer

    manager = fiber_tpu_torch.Manager()
    try:
        results = manager.dict()
        t0 = time.time()
        Ring(RING_RANKS, functools.partial(_ring_es_rank, results=results),
             initializer=torch_distributed_initializer).run()
        ring_s = time.time() - t0
        got = {r: results[r] for r in range(RING_RANKS)}
    finally:
        manager.shutdown()
    for r, row in got.items():
        check(row["device"].startswith("cuda") and row["mesh"]
              == (RING_RANKS, r), f"rank {r}: {row['device']} {row['mesh']}")
        check(row["same_start"], f"rank {r}: rank 0's broadcast initial "
              "params differ from its own")
        check(row["spread"] == 0.0 and np.array_equal(row["params"],
                                                      got[0]["params"]),
              f"rank {r}: params not replicated (spread {row['spread']})")
    es, _ = flagship_es(make_mesh("cuda", n=RING_RANKS), 4096, 500)
    k2 = es.pop_size // RING_RANKS
    gens, steps_s = [], []
    for g in range(RING_ES_GENS):
        params_in = torch.from_numpy(got[0]["params_in"][g]).cuda()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new, _ = es.step(params_in)
        torch.cuda.synchronize()
        steps_s.append(time.perf_counter() - t1)
        want_fit = es.last_fitness.cpu()
        fit = torch.from_numpy(got[0]["fitness"][g])
        check(fit.shape == want_fit.shape == (RING_RANKS, k2),
              f"fitness {tuple(fit.shape)} vs {tuple(want_fit.shape)}")
        per_rank = [int((fit[r] != want_fit[r]).sum())
                    for r in range(RING_RANKS)]
        check(max(per_rank) <= ES_LAYOUT_MISMATCHES, f"generation {g}: "
              f"{per_rank} returns a rank differ from the single process")
        following = (got[0]["params_in"][g + 1] if g + 1 < RING_ES_GENS
                     else got[0]["params"])
        err = (new.cpu() - torch.from_numpy(following)).abs().max().item()
        if max(per_rank) == 0:
            check(err == 0.0, f"generation {g}: equal returns, params "
                  f"differ by {err}")
        gens.append({"mismatches_per_rank": per_rank,
                     "params_max_abs_diff": err,
                     "distinct_returns": len(set(fit.reshape(-1).tolist()))})
    row = {"ranks": RING_RANKS, "pop": es.pop_size, "max_steps": 500,
           "generations": RING_ES_GENS,
           "evals_per_s": es.pop_size * RING_ES_GENS / got[0]["secs"],
           "single_process_evals_per_s": es.pop_size * RING_ES_GENS
           / sum(steps_s),
           "rank_seconds": [got[r]["secs"] for r in range(RING_RANKS)],
           "rank_start_s": [got[r]["entered"] - t0
                            for r in range(RING_RANKS)],
           "rank_done_s": [got[r]["done"] - t0 for r in range(RING_RANKS)],
           "ring_run_s": ring_s, "per_generation": gens,
           "mismatch_allowance": ES_LAYOUT_MISMATCHES,
           "stats": [s.tolist() for s in got[0]["stats"]]}
    emit({"phase": "ring_es", **row})
    return row


def phase_poet_pool(torch):
    """``examples/poet_distributed.py`` at ``bench.py --poet``'s width:
    the per-pair ES steps through ``Pool(POET_POOL_WORKERS)`` workers on
    the card, then the same loop in this process, equal."""
    from fiber_tpu_torch.examples import poet_distributed

    kw = dict(iterations=POET_POOL_ITERS, workers=POET_POOL_WORKERS,
              pop=4096, pairs=6, steps=500, es_steps=POET_ES_STEPS)
    runs = {}
    for route in ("pool", "in_process"):
        marks = [time.perf_counter()]
        runs[route] = poet_distributed.run(
            in_process=route == "in_process",
            log=lambda _: marks.append(time.perf_counter()), **kw)
        runs[route] += ([b - a for a, b in zip(marks, marks[1:])],)
    (hist, evals, secs, poet, iter_s), local = runs["pool"], runs["in_process"]
    check(hist == local[0], f"pool history {hist} != in-process {local[0]}")
    check(evals == local[1], f"evals {evals} vs {local[1]}")
    for a, b in zip(poet.agents + poet.envs,
                    local[3].agents + local[3].envs):
        check(a.device.type == "cuda" and torch.equal(a, b),
              "a pair differs between the pool and the in-process loop")
    check(all(math.isfinite(f) for h in hist for f in h["fitness"]),
          f"fitness {hist}")
    row = {"workers": POET_POOL_WORKERS, "iterations": POET_POOL_ITERS,
           "pop": poet.pop_size, "max_steps": 500,
           "es_steps": POET_ES_STEPS, "history": hist, "evals": evals,
           "pool_seconds": secs, "pool_evals_per_s": evals / secs,
           "pool_iteration_s": iter_s,
           "in_process_seconds": local[2],
           "in_process_evals_per_s": evals / local[2],
           "in_process_iteration_s": local[4], "equal_in_process": True}
    emit({"phase": "poet_pool", **row})
    return row


_EXIT_PROBE = """
import sys, threading, time
import torch
torch.zeros(1, device="cuda")
from fiber_tpu_torch.telemetry.device import DEVICE
DEVICE.enabled = True
bare = sys.argv[1] == "bare"
def sample():
    while True:
        if bare:
            torch.cuda.mem_get_info(0)
        else:
            DEVICE.update_gauges()
threading.Thread(target=sample, daemon=True).start()
time.sleep(0.5)
"""


def phase_exit_probe():
    """Processes on the card whose daemon thread probes the device gauges
    (the monitor sampler's probe) without pause exit 0: the probes stop
    at exit (``telemetry/device.py``, ``_stop_cuda_probes``). A daemon
    thread still in a torch call that released the GIL when Python
    finalizes aborts its process (exit -6), as a ``ring_es`` rank once
    did; the control children, looping on ``torch.cuda.mem_get_info``
    with no stop, record how often that happens here."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    kinds = (["gauges"] * EXIT_PROBE_CHILDREN
             + ["bare"] * EXIT_PROBE_CHILDREN)
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", _EXIT_PROBE, kind],
                              env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for kind in kinds]
    rcs, errs = {"gauges": [], "bare": []}, []
    try:
        for kind, proc in zip(kinds, procs):
            _, err = proc.communicate(timeout=180)
            rcs[kind].append(proc.returncode)
            if kind == "gauges" and proc.returncode:
                errs.append(err[-800:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    emit({"phase": "exit_probe", "gauges_exit_codes": rcs["gauges"],
          "bare_exit_codes": rcs["bare"], "s": time.time() - t0})
    check(not any(rcs["gauges"]), f"a process probing the gauges did not "
          f"exit cleanly: {rcs['gauges']} {errs}")


def phase_host_plane(torch):
    """The exit of processes that probe the card, the managers, the ring
    and the Pool-driven POET, with every kernel's launch count set to 0
    before them and required to stay 0 (these paths run no TPU kernel's
    counterpart; launches in rank and worker processes count there, not
    here)."""
    _reset_counts()
    phase_exit_probe()
    phase_managers(torch)
    phase_host_ring(torch)
    phase_ring_es(torch)
    phase_poet_pool(torch)
    counts = _counts()
    check(not any(counts.values()), f"kernels launched on the managers, "
          f"ring and pool-POET paths: {counts}")
    return counts


# -- the rest of the host plane: durable maps, hier dispatch, the sim ------
# -- cluster, the merged trace and the serve tier ----------------------------

def _fitness_items(n):
    """Star-items of ``tests/_torch_pool_tasks.cartpole_fitness``: one
    seed each, on the card."""
    return [(seed, "cuda", DURABLE_POP, DURABLE_STEPS) for seed in range(n)]


def _captured_generation(torch):
    """One flagship generation, captured and replayed by ``run_fused`` on
    a fresh strategy: its params and stats, and the capture's own window
    on ``time.monotonic()`` (the graph runner's ``capture_window``)."""
    es, params = _flagship_es(torch, CAPTURE_POP, CAPTURE_STEPS)
    p, s = es.run_fused(params, 1)
    torch.cuda.synchronize()
    return p, s, es._fused_runner_cache[1].capture_window


@contextlib.contextmanager
def _transfers_of_other_threads():
    """Each copy between the card and the host that the tensor reducer
    (``fiber_tpu_torch/serialization.py``) makes on a thread other than
    this one, and each ledger record made, as ``(kind, start, end)`` on
    ``time.monotonic()``: ``d2h`` where a CUDA tensor is pickled (the
    ledger's writer), ``h2d`` where one is rebuilt on the card (the
    result loop), ``ledger`` for a record's serialization and store."""
    import threading

    from fiber_tpu_torch import serialization as ser
    from fiber_tpu_torch.store import ledger as ledgermod

    main = threading.get_ident()
    log = []

    def timed(kind, fn, on_card):
        def wrapper(*args):
            if threading.get_ident() == main or not on_card(*args):
                return fn(*args)
            t0 = time.monotonic()
            try:
                return fn(*args)
            finally:
                log.append((kind, t0, time.monotonic()))
        return wrapper

    saved = (ser._host_bytes, ser._from_wire,
             ledgermod.MapLedger._durable_record)
    ser._host_bytes = timed("d2h", saved[0],
                            lambda t: t.device.type == "cuda")
    ser._from_wire = timed("h2d", saved[1],
                           lambda data, name, width, dev: dev == "cuda")
    ledgermod.MapLedger._durable_record = timed(
        "ledger", saved[2], lambda ledger, rec: True)
    try:
        yield log
    finally:
        (ser._host_bytes, ser._from_wire,
         ledgermod.MapLedger._durable_record) = saved


@contextlib.contextmanager
def _private_staging(tag):
    """``FIBER_AGENT_STAGING`` set to a new temporary directory for the
    block, with the process's object store rebuilt under it, so that the
    block's ledgers and journaled payloads go there and are removed with
    it: a run leaves no ledger in the home directory."""
    import shutil

    from fiber_tpu_torch import store as storemod

    staging = tempfile.mkdtemp(prefix=f"fiber-torch-{tag}-")
    old = os.environ.get("FIBER_AGENT_STAGING")
    os.environ["FIBER_AGENT_STAGING"] = staging
    storemod.reset()
    try:
        yield staging
    finally:
        storemod.reset()
        if old is None:
            os.environ.pop("FIBER_AGENT_STAGING", None)
        else:
            os.environ["FIBER_AGENT_STAGING"] = old
        shutil.rmtree(staging, ignore_errors=True)


def _line_count(path):
    try:
        with open(path) as fh:
            return sum(1 for _ in fh)
    except OSError:
        return 0


def _cli(argv):
    """``fiber_tpu_torch.cli.main(argv)`` in this process: its exit code
    and what it printed."""
    import io

    from fiber_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _kill_group(pid):
    """SIGKILL what is left of a process group this script started."""
    import signal

    try:
        os.killpg(pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def phase_capture_under_load(torch, card):
    """The capture of ROADMAP C's flake, now made in the thread-local
    mode: a durable map of CUDA results runs in a thread of this process
    (its result loop copies each result to the card, its ledger's writer
    thread copies each chunk back to the host) while the main thread
    captures and replays one flagship generation again and again, each
    on a fresh strategy. Every capture equals the one made alone, bit
    for bit, and at least one capture's own window (the graph runner's
    ``capture_window``, around ``torch.cuda.graph``) held a copy between
    the card and the host made by another thread. Returns the map's
    results (the uninterrupted reference of the durable and sim_cluster
    phases)."""
    import threading

    import fiber_tpu_torch
    from fiber_tpu_torch.store import ledger as ledgermod
    from tests import _torch_pool_tasks as tasks

    start = time.perf_counter()
    alone_p, alone_s, _ = _captured_generation(torch)
    job = f"chip-capture-{os.getpid()}-{os.urandom(4).hex()}"
    out, errors = {}, []

    def durable_map():
        try:
            with fiber_tpu_torch.Pool(2) as pool:
                out["results"] = pool.starmap_async(
                    tasks.cartpole_fitness, _fitness_items(CAPTURE_MAP_ITEMS),
                    chunksize=1, job_id=job).get(240)
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    with _private_staging("capture") as _, \
            _transfers_of_other_threads() as log:
        path = ledgermod.job_path(job)
        t0 = time.perf_counter()
        thread = threading.Thread(target=durable_map, name="durable-map")
        thread.start()
        deadline = time.monotonic() + 180
        while (thread.is_alive() and _line_count(path) < 3
               and time.monotonic() < deadline):
            time.sleep(0.02)   # the header and two chunks: the writer runs
        windows = []
        while thread.is_alive() and time.monotonic() < deadline + 60:
            t1 = time.perf_counter()
            p, s, window = _captured_generation(torch)
            windows.append((time.perf_counter() - t1, window))
            check(torch.equal(p, alone_p) and torch.equal(s, alone_s),
                  "a capture beside the durable map differs from the "
                  "capture made alone")
        thread.join(300)
        map_s = time.perf_counter() - t0
        check(not errors and not thread.is_alive(),
              f"the durable map failed: {errors!r}")
        _, completed, done = ledgermod.load(path)
    captures = []
    for seconds, (w0, w1) in windows:
        inside = {kind: sum(1 for k, a, b in log
                            if k == kind and a < w1 and b > w0)
                  for kind in ("d2h", "h2d", "ledger")}
        captures.append({"seconds": seconds, "capture_s": w1 - w0,
                         **{f"{k}_in_capture": n
                            for k, n in inside.items()}})
    overlapped = sum(c["d2h_in_capture"] + c["h2d_in_capture"] > 0
                     for c in captures)
    check(overlapped >= 1, "no capture's window held another thread's "
          f"copy between the card and the host: {captures}")
    results = out["results"]
    check(len(results) == CAPTURE_MAP_ITEMS and all(
        r.device.type == "cuda" and bool(torch.isfinite(r).all())
        for r in results), "the durable map's results")
    check(done and len(completed) == CAPTURE_MAP_ITEMS,
          f"the map's ledger: {len(completed)} chunks, done={done}")
    emit({"phase": "capture_under_load", "card": card,
          "capture_error_mode": "thread_local",
          "captures": len(captures),
          "captures_with_transfers_inside": overlapped,
          "transfers_of_other_threads": {
              kind: sum(1 for k, _, _ in log if k == kind)
              for kind in ("d2h", "h2d", "ledger")},
          "capture_runs": captures, "equal_alone": True,
          "map_items": CAPTURE_MAP_ITEMS, "map_seconds": map_s,
          "map_chunks_journaled": len(completed),
          "phase_seconds": time.perf_counter() - start})
    return results


def phase_durable(torch, card, reference):
    """README's durable ES map on the card: a subprocess master runs
    ``Pool(2).starmap(cartpole_fitness, ..., job_id=...)``, whose tasks
    return CUDA fitness tensors; the port's chaos plan SIGKILLs it once
    DURABLE_KILL_AFTER chunks are journaled; ``python -m
    fiber_tpu_torch.cli resume`` finishes the map. The resume restores
    exactly the journaled chunks and executes the rest, and its results
    load here as CUDA tensors on cuda:0, equal bit for bit to the
    uninterrupted map's."""
    import shutil
    import signal

    from fiber_tpu_torch import serialization
    from fiber_tpu_torch.store import ledger as ledgermod
    from fiber_tpu_torch.testing import chaos

    start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    staging = tempfile.mkdtemp(prefix="fiber-torch-durable-")
    job = f"chip-durable-{os.getpid()}"
    plan = chaos.ChaosPlan(seed=7, token_dir=os.path.join(staging, "tokens"),
                           kill_master_after_chunks=DURABLE_KILL_AFTER,
                           kill_master_times=1)
    env = dict(os.environ, FIBER_AGENT_STAGING=staging,
               FIBER_BACKEND="local")
    env.pop(chaos.ENV_VAR, None)
    items = _fitness_items(DURABLE_ITEMS)
    # the master makes its CUDA context before the map, so that its
    # result loop does not stall behind it while every chunk completes
    script = (
        "import torch\n"
        "import fiber_tpu_torch\n"
        "from tests import _torch_pool_tasks as tasks\n"
        "torch.zeros(1, device='cuda')\n"
        "with fiber_tpu_torch.Pool(2) as pool:\n"
        f"    pool.starmap(tasks.cartpole_fitness, {items!r},\n"
        f"                 chunksize={DURABLE_CHUNK}, job_id={job!r})\n")
    t0 = time.perf_counter()
    master = subprocess.Popen(
        [sys.executable, "-c", script], cwd=root, start_new_session=True,
        env={**env, chaos.ENV_VAR: plan.to_env()},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _, err = master.communicate(timeout=300)
    finally:
        _kill_group(master.pid)  # the dead master's orphaned workers
    map_s = time.perf_counter() - t0
    check(master.returncode == -signal.SIGKILL,
          f"the master exited {master.returncode}, not by SIGKILL: "
          f"{err[-2000:]}")
    ledger_path = ledgermod.job_path(job, os.path.join(staging, "ledger"))
    header, completed, done = ledgermod.load(ledger_path)
    n_chunks = DURABLE_ITEMS // DURABLE_CHUNK
    journaled = len(completed)
    check(not done and DURABLE_KILL_AFTER <= journaled < n_chunks,
          f"the master died with {journaled} of {n_chunks} chunks "
          f"journaled (done={done})")
    ledger_bytes = os.path.getsize(ledger_path)
    payload_bytes = sum(os.path.getsize(os.path.join(
        staging, "objects", f"{digest}.obj"))
        for _, digest in completed.values())
    out_path = os.path.join(staging, "results.bin")
    t1 = time.perf_counter()
    resume = subprocess.Popen(
        [sys.executable, "-m", "fiber_tpu_torch.cli", "resume", job,
         "--processes", "2", "--out", out_path], cwd=root, env=env,
        start_new_session=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        stdout, err = resume.communicate(timeout=300)
    finally:
        _kill_group(resume.pid)
    resume_s = time.perf_counter() - t1
    check(resume.returncode == 0, f"resume failed: {err[-2000:]}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    check(summary["tasks"] == DURABLE_ITEMS
          and summary["restored_chunks"] == journaled
          and summary["restored_tasks"] == DURABLE_CHUNK * journaled
          and summary["executed_tasks"]
          == DURABLE_ITEMS - summary["restored_tasks"]
          and summary["trace"] == header["trace"],
          f"resume summary {summary} after {journaled} journaled chunks")
    with open(out_path, "rb") as fh:
        results = serialization.loads(fh.read())
    check(len(results) == DURABLE_ITEMS and all(
        r.device == torch.device("cuda", 0) for r in results),
        "resumed results are not CUDA tensors on cuda:0")
    check(all(r.dtype == w.dtype and torch.equal(r, w)
              for r, w in zip(results, reference)),
          "resumed results differ from the uninterrupted map's")
    _, after, done_after = ledgermod.load(ledger_path)
    check(done_after and len(after) == n_chunks,
          f"the resumed ledger: {len(after)} chunks, done={done_after}")
    shutil.rmtree(staging, ignore_errors=True)
    emit({"phase": "durable", "card": card, "items": DURABLE_ITEMS,
          "chunks": n_chunks, "pop": DURABLE_POP, "steps": DURABLE_STEPS,
          "master_exit": master.returncode, "journaled_chunks": journaled,
          "resume": summary, "equal_uninterrupted": True,
          "results_device": str(results[0].device),
          "ledger_file_bytes": ledger_bytes,
          "ledger_payload_bytes": payload_bytes,
          "map_until_kill_s": map_s, "resume_s": resume_s,
          "phase_seconds": time.perf_counter() - start})


def phase_hier(torch, card):
    """``init(cpu_per_job=2, dispatch_mode="hier")``: a ``Pool(2)`` whose
    one job is a sub-master that forks two sub-workers maps 8 MB CUDA
    tensors to what a direct pool returns, with ranges handed out; then
    a SIGKILL of the sub-master mid-map loses no task. Returns the
    items and the direct pool's results (the serve phase's reference)."""
    import fiber_tpu_torch
    from fiber_tpu_torch import telemetry
    from tests import _torch_pool_tasks as tasks

    start = time.perf_counter()
    t = torch.randn(HIER_TENSOR_MB << 18, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(41))
    items = [(t, k) for k in range(HIER_ITEMS)]
    fiber_tpu_torch.init()
    t0 = time.perf_counter()
    with fiber_tpu_torch.Pool(2) as pool:
        direct = pool.starmap(tasks.tensor_affine, items, chunksize=1)
    direct_s = time.perf_counter() - t0
    ranges = telemetry.REGISTRY.counter("sched_decisions")
    ranges0 = ranges.value(kind="range")
    try:
        fiber_tpu_torch.init(cpu_per_job=2, dispatch_mode="hier")
        t0 = time.perf_counter()
        with fiber_tpu_torch.Pool(2) as pool:
            got = pool.starmap(tasks.tensor_affine, items, chunksize=1)
            idents = len(pool._hier_idents)
            degraded = pool._hier_degraded
        hier_s = time.perf_counter() - t0
        handouts = ranges.value(kind="range") - ranges0
        t0 = time.perf_counter()
        with fiber_tpu_torch.Pool(2) as pool:
            xs = list(range(HIER_KILL_ITEMS))
            res = pool.map_async(tasks.sleep_echo, xs, chunksize=2)
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and (
                    not pool._hier_idents or pool._n_completed < 10):
                time.sleep(0.02)
            check(pool._hier_idents and pool._n_completed >= 10,
                  "the sub-master never held work")
            done_at_kill = pool._n_completed
            with pool._workers_lock:
                victim = pool._workers[0]
            victim.kill()
            back = res.get(300)
            check(back == xs, "tasks lost across the sub-master's SIGKILL")
            check(pool._hier_degraded, "the pool kept the dead hierarchy")
            resubmitted = pool.stats()["chunks_resubmitted"]
        kill_s = time.perf_counter() - t0
    finally:
        fiber_tpu_torch.init()
    check(idents > 0 and not degraded, f"sub-masters {idents}, degraded "
          f"{degraded}")
    check(handouts > 0, "no range was handed out")
    for (out, where), (ref, _), (t_in, k) in zip(got, direct, items):
        check(out.device.type == "cuda" and where == "cuda",
              f"a hier result on {out.device}, the worker saw {where}")
        check(torch.equal(out, ref) and torch.equal(out, t_in * 2 + k),
              "a hier result differs from the direct pool's")
    emit({"phase": "hier", "card": card, "items": HIER_ITEMS,
          "tensor_mb": HIER_TENSOR_MB, "sub_masters": idents,
          "range_handouts": handouts, "equal_direct": True,
          "direct_s": direct_s, "hier_s": hier_s,
          "kill_items": HIER_KILL_ITEMS, "completed_at_kill": done_at_kill,
          "chunks_resubmitted": resubmitted, "tasks_lost": 0,
          "kill_map_s": kill_s, "phase_seconds": time.perf_counter() - start})
    return items, direct


def phase_sim_cluster(torch, card, reference):
    """``init(backend="tpu", tpu_hosts="sim:2")``: two host agents on this
    machine share the card; a ``Pool(2)`` of CartPole evaluations over
    them returns the local pool's results bit for bit. Against the live
    agents, ``devices`` and ``top`` show each host's card memory in the
    HBM column (the agents read it through NVML and report it as
    ``card_hbm``, rendered with a '*'), and ``doctor`` prints
    the CUDA probe's line with the card's name."""
    import fiber_tpu_torch
    from fiber_tpu_torch.backends import get_backend, reset_backends
    from tests import _torch_pool_tasks as tasks

    start = time.perf_counter()
    env_backend = os.environ.get("FIBER_BACKEND")
    os.environ["FIBER_BACKEND"] = "tpu"   # the environment outranks init
    fiber_tpu_torch.init(backend="tpu", tpu_hosts="sim:2")
    reset_backends()
    views = {}
    try:
        t0 = time.perf_counter()
        with fiber_tpu_torch.Pool(2) as pool:
            got = pool.starmap(tasks.cartpole_fitness,
                               _fitness_items(SIM_ITEMS), chunksize=1)
            map_s = time.perf_counter() - t0
            backend = get_backend()
            check(type(backend).__name__ == "TpuBackend",
                  f"the pool ran on {type(backend).__name__}")
            hosts = backend._resolved_hosts_spec()
            for name, argv in (
                    ("devices", ["devices", "--hosts", hosts]),
                    ("top", ["top", "--hosts", hosts, "--iterations", "1",
                             "--no-clear"]),
                    ("doctor", ["doctor", "--hosts", hosts,
                                "--timeout", "120"])):
                views[name] = _cli(argv)
    finally:
        get_backend("tpu").shutdown_sim_cluster()
        if env_backend is None:
            os.environ.pop("FIBER_BACKEND", None)
        else:
            os.environ["FIBER_BACKEND"] = env_backend
        fiber_tpu_torch.init()
        reset_backends()
    check(all(r.device.type == "cuda" and torch.equal(r, w)
              for r, w in zip(got, reference)) and len(got) == SIM_ITEMS,
          "the sim cluster's results differ from the local pool's")
    hbm = {}
    for name in ("devices", "top"):
        rc, text = views[name]
        check(rc == 0, f"cli {name} exited {rc}: {text[-1000:]}")
        for host in hosts.split(","):
            row = next((ln for ln in text.splitlines()
                        if ln.startswith(host)), "")
            cell = HBM_CELL.search(row)
            check(cell is not None, f"cli {name}: no HBM numbers for "
                  f"{host}: {row!r}")
            hbm[f"{name} {host}"] = cell.group(0)
    rc, text = views["doctor"]
    probe = next((ln for ln in text.splitlines() if "cuda devices" in ln),
                 "")
    name = torch.cuda.get_device_name(0)
    check(rc == 0 and probe.startswith("[ok  ]")
          and f"platform=cuda count={torch.cuda.device_count()} "
          f"device0={name}" in probe, f"doctor: {text[-1500:]}")
    emit({"phase": "sim_cluster", "card": card, "hosts": hosts,
          "items": SIM_ITEMS, "equal_local_pool": True, "map_s": map_s,
          "hbm_cells": hbm, "doctor_cuda_line": probe,
          "phase_seconds": time.perf_counter() - start})


def phase_trace(torch, card, items):
    """A ``profiling.trace`` region around a pool map of CUDA tensors and
    one ``flash_fwd`` call, whose output and lse are held against the
    plain attention on the same inputs; ``Pool.trace_dump`` then holds
    the host spans and the card's events, ``flash_fwd_kernel`` among
    them in a ``CUDA`` lane, and ``cli explain`` turns the dump and a
    ``flight_dump`` into a blame verdict."""
    import shutil

    import fiber_tpu_torch
    from fiber_tpu_torch.ops import flash_attention as fa
    from fiber_tpu_torch.telemetry import tracing
    from fiber_tpu_torch.utils import profiling
    from tests import _torch_pool_tasks as tasks

    start = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="fiber-torch-trace-")
    s, h, d = TRACE_FLASH_SHAPE
    g = torch.Generator(device="cuda").manual_seed(51)
    q, k, v = (torch.randn(s, h, d, generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    fiber_tpu_torch.init()
    tracing.SPANS.clear()   # the dump holds this phase's spans only
    with fiber_tpu_torch.Pool(2) as pool:
        pool.map(tasks.square, range(2), chunksize=1)  # workers up
        t0 = time.perf_counter()
        with profiling.trace(os.path.join(workdir, "prof")):
            outs = pool.starmap(tasks.tensor_affine, items, chunksize=1)
            o, lse = fa.flash_fwd(q, k, v, causal=True)
        traced_s = time.perf_counter() - t0
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and sum(
                sp["name"] == "worker.execute"
                for sp in tracing.SPANS.snapshot()) < len(items):
            time.sleep(0.05)
        trace_path = pool.trace_dump(os.path.join(workdir, "trace.json"))
        flight_path = pool.flight_dump(os.path.join(workdir, "flight.json"))
    check(all(torch.equal(out, t_in * 2 + kk)
              for (out, _), (t_in, kk) in zip(outs, items)),
          "the traced map's results")
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=True)
    err = (o.float() - ro.float()).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    del ro, rlse
    check(bool(torch.isfinite(o.float()).all())
          and bool(torch.isfinite(lse).all())
          and err < TOL["bfloat16"] and lse_err < LSE_TOL,
          f"flash_fwd in the trace: max_abs_err {err} lse_err {lse_err}")
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    lanes = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    cuda_lanes = sorted({n for n in lanes.values() if n.startswith("CUDA ")})
    device_events = [e for e in events if e.get("ph") == "X" and
                     lanes.get(e.get("pid"), "").startswith("CUDA ")]
    flash = [e for e in device_events
             if "flash_fwd_kernel" in e.get("name", "")]
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("name") in ("pool.serialize", "worker.execute")]
    check(flash, f"no flash_fwd_kernel event in a CUDA lane: {cuda_lanes}")
    check(len(spans) >= len(items) + 1, f"{len(spans)} host spans")
    rc, text = _cli(["explain", trace_path, "--flight", flight_path])
    blame = next((ln for ln in text.splitlines()
                  if ln.startswith("primary:")), "")
    check(rc == 0 and blame, f"explain: {text[-1500:]}")
    size = os.path.getsize(trace_path)
    shutil.rmtree(workdir, ignore_errors=True)
    emit({"phase": "trace", "card": card, "events": len(events),
          "device_events": len(device_events), "cuda_lanes": cuda_lanes,
          "flash_fwd_kernel_events": len(flash),
          "flash_fwd_max_abs_err": err, "flash_fwd_lse_err": lse_err,
          "flash_fwd_tol": TOL["bfloat16"],
          "flash_fwd_kernel_us": flash[0].get("dur"),
          "flash_fwd_kernel_name": flash[0]["name"][:120],
          "host_spans": len(spans), "trace_bytes": size,
          "explain_blame": blame, "traced_s": traced_s,
          "phase_seconds": time.perf_counter() - start})


def phase_serve(torch, card, items, direct):
    """A serve daemon on localhost with a warm pool of 2: a submitted map
    of CUDA-tensor items ends done, its results equal the direct pool's
    and ``history`` shows it done; a second job is cancelled through the
    CLI and parks resumable. The daemon's ledgers and journal go to a
    private staging root, removed after."""
    from fiber_tpu_torch import config
    from fiber_tpu_torch.serve import protocol
    from fiber_tpu_torch.serve.client import ServeClient
    from fiber_tpu_torch.serve.daemon import ServeDaemon
    from fiber_tpu_torch.serve.jobs import JobRunner
    from fiber_tpu_torch.store import ledger as ledgermod
    from tests import _torch_pool_tasks as tasks

    start = time.perf_counter()
    stack = contextlib.ExitStack()
    cfg = config.get()
    knobs = {"serve_warm_floor": 2, "serve_tick_s": 0.05}
    old = {k: getattr(cfg, k) for k in knobs}
    cfg.update(**knobs)
    try:
        staging = stack.enter_context(_private_staging("serve"))
        runner = JobRunner(processes=2,
                           journal_dir=os.path.join(staging, "journal"))
        daemon = ServeDaemon(port=0, runner=runner)
        daemon.start_background()
        address = f"127.0.0.1:{daemon.port}"
        client = ServeClient(("127.0.0.1", daemon.port))
        try:
            t0 = time.perf_counter()
            job = client.submit(tasks.tensor_affine, items, tenant="chip",
                                job_id=f"chip-serve-{os.getpid()}",
                                star=True, chunksize=1)
            view = client.wait(job, timeout=300)
            check(view["state"] == protocol.DONE, f"serve job: {view}")
            results = client.results(job)
            job_s = time.perf_counter() - t0
            history = ""
            deadline = time.monotonic() + 60
            while not history and time.monotonic() < deadline:
                rc, text = _cli(["history", "slo_obs", "--serve", address])
                check(rc == 0, f"history exited {rc}")
                history = next((ln for ln in text.splitlines()
                                if f"job_id={job}" in ln), "")
                time.sleep(0.1)
            check("state=done" in history, f"history: {history!r}")
            second = f"chip-serve-cancel-{os.getpid()}"
            client.submit(tasks.sleep_echo, range(SERVE_CANCEL_ITEMS),
                          tenant="chip", job_id=second, chunksize=1)
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and not ledgermod.load(
                    ledgermod.job_path(second))[1]:
                time.sleep(0.05)
            rc, text = _cli(["cancel", second, "--serve", address])
            check(rc == 0, f"cancel: {text}")
            cancelled = client.wait(second, timeout=120)
            check(cancelled["state"] == protocol.CANCELLED,
                  f"the cancelled job: {cancelled}")
            _, parked, closed = ledgermod.load(ledgermod.job_path(second))
            check(not closed, "the cancelled job's ledger is closed")
        finally:
            client.close()
            daemon.stop(terminate_pool=True)
    finally:
        cfg.update(**old)
        stack.close()
    check(len(results) == len(direct) and all(
        out.device.type == "cuda" and torch.equal(out, ref)
        for (out, _), (ref, _) in zip(results, direct)),
        "the served results differ from the direct pool's")
    emit({"phase": "serve", "card": card, "items": len(items),
          "equal_direct_pool": True, "job_s": job_s,
          "history_line": history, "cancelled": cancelled["state"],
          "cancelled_items": SERVE_CANCEL_ITEMS,
          "cancelled_chunks_journaled": len(parked),
          "phase_seconds": time.perf_counter() - start})


def phase_host_plane_2(torch, card):
    """The rest of the host plane, with every kernel's launch count set
    to 0 before it and read after: the capture beside a durable map,
    the durable map's SIGKILL and resume, hier dispatch, the sim
    cluster, the merged trace (whose one ``flash_fwd`` call is this
    path's only launch) and the serve tier."""
    _reset_counts()
    reference = phase_capture_under_load(torch, card)
    phase_durable(torch, card, reference[:DURABLE_ITEMS])
    items, direct = phase_hier(torch, card)
    phase_sim_cluster(torch, card, reference[:SIM_ITEMS])
    phase_trace(torch, card, items)
    phase_serve(torch, card, items, direct)
    counts = _counts()
    check(counts["flash_fwd"] == 1 and not any(
        n for name, n in counts.items() if name != "flash_fwd"),
        f"launches on the rest of the host plane: {counts}")
    return counts


# -- POET and bench.py's other ES envs --------------------------------------

def _record_poet_draws(poet):
    """Wraps ``poet``'s draw methods so that every draw it takes is kept
    on the host, each kind in its order: the minimal criterion's,
    transfer's and proposal's states, the parent picks, the mutation
    noise, and each ES step's noise and initial states. The last two
    are drawn inside the captured step: the wrappers keep the tensors
    that the capture drew into, which every replay overwrites, and the
    runner's wrapper copies them after each replay."""
    draws = {"es": [], "reset": [], "parent": [], "mutation": []}
    es, live = poet._es, {}
    noise, reset_fn, runner = es._noise, es.reset_fn, poet._runner

    def rec_noise():
        live["eps"] = noise()
        return live["eps"]

    def rec_reset_fn(n, generator):
        live["states"] = reset_fn(n, generator)
        return live["states"]

    def rec_runner(combined):
        out = runner(combined)
        draws["es"].append((live["eps"].cpu(), live["states"].cpu()))
        return out

    def recorded(fn, kind):
        def rec(*args):
            out = fn(*args)
            draws[kind].append(out.cpu() if hasattr(out, "cpu") else out)
            return out
        return rec

    es._noise, es.reset_fn = rec_noise, rec_reset_fn
    poet._runner = rec_runner
    poet._reset = recorded(poet._reset, "reset")
    poet._pick_parent = recorded(poet._pick_parent, "parent")
    poet._mutation_noise = recorded(poet._mutation_noise, "mutation")
    return draws


def _feed_poet_draws(poet, draws):
    """Points ``poet``'s draw methods at recorded ``draws``; returns the
    queues, which a run must empty."""
    q = {k: list(v) for k, v in draws.items()}
    pending = []

    def noise():
        eps, states = q["es"].pop(0)
        pending.append(states)
        return eps

    poet._es._noise = noise
    poet._es.reset_fn = lambda n, generator: pending.pop()
    poet._reset = lambda n: q["reset"].pop(0)
    poet._pick_parent = lambda n: q["parent"].pop(0)
    poet._mutation_noise = lambda: q["mutation"].pop(0)
    return q


def _poet_finetune(torch):
    """One pair's ES_STEPS-generation fine-tune of bench.py --poet's POET
    through its runner (the first call captures the pinned ES step)
    against as many eager pinned steps from the same generator state:
    the agent bitwise, the stats equal, the env tail pinned, the
    generator's state equal. Then the profiler's view of one replayed
    ES generation, and its time by CUDA events."""
    from fiber_tpu_torch.entry import make_poet

    poet = make_poet(device="cuda")
    dim, theta0, env = poet.policy.dim, poet.agents[0], poet.envs[0]
    gen0 = poet.generator.get_state()
    theta, stats = poet._finetune(theta0, env, POET_ES_STEPS)
    fused_gen = poet.generator.get_state()
    poet.generator.set_state(gen0)
    with torch.no_grad():
        combined = torch.cat([theta0, env])
        for _ in range(POET_ES_STEPS):
            combined, eager_stats = poet._pinned_step(combined)
    check(torch.equal(_bits(torch, theta), _bits(torch, combined[:dim]))
          and torch.equal(stats, eager_stats)
          and torch.equal(combined[dim:], env)
          and torch.equal(fused_gen, poet.generator.get_state()),
          "poet: the replayed fine-tune differs from eager pinned steps")
    graph = poet._runner.graph
    return {"es_steps": POET_ES_STEPS, "agent_bitwise": True,
            "stats_equal": True, "stats": stats.tolist(),
            "replay": device_breakdown(torch, graph.replay),
            "replay_ms": cuda_ms(torch, graph.replay, reps=3)}


def _poet_card_vs_cpu(torch, ranks=1):
    """A small POET (POET_SMALL) for POET_SMALL_ITERS iterations on
    ``ranks`` ranks of the card, every draw recorded, then the same POET
    on as many CPU ranks fed those draws: histories with the same counts
    (pairs, spawned, transfers, transfer evals, archive), every draw
    used; the mean fitness and the agents beside them."""
    from fiber_tpu_torch.entry import make_poet

    card = make_poet(device="cuda", ranks=ranks, **POET_SMALL)
    cpu = make_poet(device="cpu", ranks=ranks, **POET_SMALL)
    draws = _record_poet_draws(card)
    want = card.run(POET_SMALL_ITERS, es_steps=POET_ES_STEPS)
    queues = _feed_poet_draws(cpu, draws)
    got = cpu.run(POET_SMALL_ITERS, es_steps=POET_ES_STEPS)
    check(not any(queues.values()), "poet card vs cpu: draws left over: "
          f"{ {k: len(v) for k, v in queues.items()} }")
    check(got == want, f"poet card vs cpu: histories differ: {want} "
          f"against {got}")
    err = max((a.cpu() - b).abs().max().item()
              for a, b in zip(card.agents, cpu.agents))
    return {**POET_SMALL, "ranks": ranks, "iterations": POET_SMALL_ITERS,
            "histories_equal": True, "agents_max_abs_err": err,
            "draws": {k: len(v) for k, v in draws.items()},
            "history": want}


@contextlib.contextmanager
def _timed(torch, cls, names):
    """Times every call of ``cls``'s methods ``names`` (host clock
    around work that ends in a device synchronise) while the block
    runs; yields the seconds and calls by method name."""
    split = {name: {"seconds": 0.0, "calls": 0} for name in names}
    saved = {name: getattr(cls, name) for name in names}

    def timed(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            split[name]["seconds"] += time.perf_counter() - t0
            split[name]["calls"] += 1
            return out
        return call

    for name, fn in saved.items():
        setattr(cls, name, timed(name, fn))
    try:
        yield split
    finally:
        for name, fn in saved.items():
            setattr(cls, name, fn)


def phase_poet(torch):
    """bench.py --poet through ``run_poet`` (ParamCartPole, MLP (16,), pop
    4096, 500 steps, 6 pairs, 4 ES steps a pair) for POET_ITERS
    iterations: evals/s as bench.py counts them, the co-evolution's
    pairs, transfers and archive. Then one fine-tune replayed against
    eager steps, and a small POET on the card against the CPU."""
    from fiber_tpu_torch.entry import run_poet
    from fiber_tpu_torch.ops.poet import POET

    start = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _timed(torch, POET, ("optimize_pair", "try_spawn_envs",
                              "transfer")) as split:
        history, evals, perf = run_poet(device="cuda",
                                        iterations=POET_ITERS,
                                        es_steps=POET_ES_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(len(history) == POET_ITERS
          and all(math.isfinite(h["mean_fitness"]) for h in history)
          and all(1 <= h["pairs"] <= 6 and h["archive_size"] >= h["pairs"]
                  for h in history), f"poet history {history}")
    emit({"phase": "poet", "pop": 4096, "max_steps": 500, "max_pairs": 6,
          "es_steps": POET_ES_STEPS, "iterations": POET_ITERS,
          "hidden": [16], "seconds": secs, "evals": evals,
          "poet_policy_evals_per_sec": evals / secs, "run_poet_perf": perf,
          "seconds_by_stage": split,
          "final_pairs": history[-1]["pairs"],
          "total_transfers": sum(h["transfers"] for h in history),
          "archive_size": history[-1]["archive_size"], "history": history,
          "finetune": _poet_finetune(torch),
          "card_vs_cpu": _poet_card_vs_cpu(torch),
          "phase_seconds": time.perf_counter() - start})
    _check_mfu(perf, "run_poet")


def phase_poet_mesh(torch):
    """POET with every ES generation over RANKS ranks of the card: the
    small POET card against CPU (both on RANKS ranks), then
    POET_MESH_ITERS iteration of bench.py --poet at full width through
    ``run_poet(ranks=RANKS)``, timed as ``run_poet`` times it."""
    from fiber_tpu_torch.entry import run_poet

    start = time.perf_counter()
    small = _poet_card_vs_cpu(torch, ranks=RANKS)
    history, evals, perf = run_poet(device="cuda", iterations=POET_MESH_ITERS,
                                    es_steps=POET_ES_STEPS, ranks=RANKS)
    check(len(history) == POET_MESH_ITERS
          and all(math.isfinite(h["mean_fitness"]) for h in history),
          f"poet over {RANKS} ranks: history {history}")
    _check_mfu(perf, "run_poet(ranks)")
    emit({"phase": "poet_mesh", "ranks": RANKS, "pop": 4096,
          "max_steps": 500, "max_pairs": 6, "es_steps": POET_ES_STEPS,
          "iterations": POET_MESH_ITERS, "evals": evals, **perf,
          "history": history, "card_vs_cpu": small,
          "phase_seconds": time.perf_counter() - start})


def _resumed_es(torch, path):
    """The flagship ES with Adam: CKPT_ES_GENS replayed generations, a
    checkpoint (params, the generator's state, Adam's (m, v, t) in
    ``extra``), then CKPT_ES_GENS more twice: on a fresh strategy of
    another seed restored from the file, and on the first strategy,
    whose captured graph has the generator registered, with its state
    set back from the file. Both against 2 * CKPT_ES_GENS generations
    in one run: params, stats, Adam's state and the generator's state
    bit for bit."""
    from fiber_tpu_torch.utils import checkpoint

    pop, steps, n = 4096, 500, CKPT_ES_GENS
    first, p0 = _flagship_es(torch, pop, steps, optimizer="adam")
    p_mid, s_first = first.run_fused(p0, n)
    checkpoint.save_es_state(path, p_mid, first.generator, generation=n,
                             extra=first._opt_state)
    whole, _ = _flagship_es(torch, pop, steps, optimizer="adam")
    want_p, want_s = whole.run_fused(p0, 2 * n)

    fresh, _ = _flagship_es(torch, pop, steps, optimizer="adam")
    rows = {}
    for label, es in (("fresh_strategy", fresh), ("captured_graph", first)):
        params, key, gen, extra = checkpoint.load_es_state(path, "cuda")
        check(gen == n, f"checkpoint generation {gen}")
        es.generator.manual_seed(99)     # a state the file must replace
        es.generator.set_state(key)
        es._opt_state = extra
        p, s = es.run_fused(params, n)
        same = (torch.equal(_bits(torch, p), _bits(torch, want_p))
                and torch.equal(torch.cat([s_first, s]), want_s)
                and all(torch.equal(a, b) for a, b in zip(es._opt_state,
                                                          whole._opt_state))
                and torch.equal(es.generator.get_state(),
                                whole.generator.get_state()))
        check(same, f"es resumed on the {label} differs from the "
              "uninterrupted run")
        rows[label] = {"bitwise": True}
    return {"pop": pop, "max_steps": steps, "optimizer": "adam",
            "generations": [n, n], "file_bytes": os.path.getsize(path),
            "stats": want_s.tolist(), **rows}


def _resumed_poet(torch, path):
    """The small POET on the card: CKPT_POET_ITERS iteration, a
    checkpoint, a fresh POET of another seed restored from it and as
    many more, against 2 * CKPT_POET_ITERS iterations in one run: the
    later records (all but their index), the pairs bit for bit, the
    archive, and both generators' states equal."""
    from fiber_tpu_torch.entry import make_poet
    from fiber_tpu_torch.utils import checkpoint

    n = CKPT_POET_ITERS
    first = make_poet(device="cuda", **POET_SMALL)
    first.run(n, es_steps=POET_ES_STEPS)
    checkpoint.save_poet_state(path, first, iteration=n)
    fresh = make_poet(device="cuda", seed=7, **POET_SMALL)
    _, it = checkpoint.load_poet_state(path, fresh)
    got = fresh.run(n, es_steps=POET_ES_STEPS)
    whole = make_poet(device="cuda", **POET_SMALL)
    want = whole.run(2 * n, es_steps=POET_ES_STEPS)

    def drop(h):
        return {k: v for k, v in h.items() if k != "iteration"}

    same = (it == n and [drop(h) for h in got] == [drop(h)
                                                  for h in want[n:]]
            and len(fresh.agents) == len(whole.agents)
            and all(torch.equal(_bits(torch, a), _bits(torch, b))
                    for a, b in zip(fresh.agents + fresh.envs,
                                    whole.agents + whole.envs))
            and [a.tolist() for a in fresh.archive] == [
                a.tolist() for a in whole.archive]
            and torch.equal(fresh.generator.get_state(),
                            whole.generator.get_state())
            and torch.equal(fresh.pick_generator.get_state(),
                            whole.pick_generator.get_state()))
    check(same, f"poet resumed from a checkpoint differs: {got} against "
          f"{want[n:]}")
    return {**POET_SMALL, "iterations": [n, n], "bitwise": True,
            "file_bytes": os.path.getsize(path), "history": want}


def phase_checkpoint(torch):
    """Runs resumed from checkpoint files on the card against the
    uninterrupted runs (``_resumed_es``, ``_resumed_poet``)."""
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        es = _resumed_es(torch, os.path.join(tmp, "es.npz"))
        poet = _resumed_poet(torch, os.path.join(tmp, "poet.npz"))
    emit({"phase": "checkpoint", "es": es, "poet": poet,
          "phase_seconds": time.perf_counter() - start})


def _env_cases(torch):
    """(name, policy, eval_fn, reset_fn, survival) of the envs and
    policies beside bench.py's, each one ES step card against CPU."""
    from fiber_tpu_torch.models.envs import (
        CartPole,
        ParamHillWalker,
        Pendulum,
        rollout_recurrent,
    )
    from fiber_tpu_torch.models.policies import GRUPolicy, MLPPolicy

    gru = GRUPolicy(4, 2, hidden=32)
    bf16 = MLPPolicy(4, 2, hidden=(32, 32), compute_dtype="bfloat16")
    pend = MLPPolicy(3, 1, hidden=(32, 32))
    hill = MLPPolicy(4, 3, hidden=(32, 32))
    terrain = (0.3, -0.2, 0.15, 0.1, -0.05, 0.05)
    return [
        ("gru_cartpole", gru, lambda th, st: rollout_recurrent(
            CartPole, gru, th, st, max_steps=ENV_CHECK_STEPS),
         CartPole.reset, True),
        ("mlp_bf16_cartpole", bf16, lambda th, st: CartPole.rollout(
            bf16.act, th, st, max_steps=ENV_CHECK_STEPS),
         CartPole.reset, True),
        ("pendulum", pend, lambda th, st: Pendulum.rollout(
            lambda p, o: pend.apply(p, o)[:, 0], th, st),
         Pendulum.reset, False),
        ("hill_walker", hill, lambda th, st: ParamHillWalker.rollout_p(
            hill.act, torch.tensor(terrain, device=th.device), th, st),
         ParamHillWalker.reset, False),
    ]


def _env_card_vs_cpu(torch):
    """For each of ``_env_cases``: one ES step at pop ENV_CHECK_POP on the
    card and on the CPU from the same params, noise and initial states
    (drawn on the card): at least ENV_SURVIVAL_SHARE of the survival
    returns agree exactly, and ENV_CONTINUOUS_SHARE of the continuous
    ones within ENV_RETURN_TOL relative. Then the biped over its 400 steps, card against
    CPU on BIPED_CHECK_POP members: the share of returns within
    ENV_RETURN_TOL, reported, not held (the biped is chaotic)."""
    from fiber_tpu_torch.entry import make_es
    from fiber_tpu_torch.ops.es import EvolutionStrategy

    rows = {}
    for name, policy, eval_fn, reset_fn, survival in _env_cases(torch):
        g = torch.Generator(device="cuda").manual_seed(3)
        params = policy.init(torch.Generator().manual_seed(0),
                             device="cuda")
        eps = torch.randn(ENV_CHECK_POP // 2, policy.dim, generator=g,
                          device="cuda")
        states = reset_fn(ENV_CHECK_POP, g)
        out = {}
        for dev in ("cuda", "cpu"):
            es = EvolutionStrategy(eval_fn, reset_fn, dim=policy.dim,
                                   pop_size=ENV_CHECK_POP, sigma=0.1,
                                   lr=0.03, device=dev)
            p, s = es.step(params.to(dev), eps=eps.to(dev),
                           states=states.to(dev))
            out[dev] = (p.cpu(), s.cpu(), es.last_fitness.reshape(-1).cpu())
        (pc, sc, fc), (pp, sp, fp) = out["cuda"], out["cpu"]
        rel = ((fc - fp).abs() / fp.abs().clamp(min=1.0))
        agree = ((fc == fp) if survival else (rel <= ENV_RETURN_TOL))
        agree = agree.float().mean().item()
        share = ENV_SURVIVAL_SHARE if survival else ENV_CONTINUOUS_SHARE
        check(agree >= share, f"{name}: only {agree} of the card's returns "
              "agree with the CPU's")
        rows[name] = {"returns_agree": agree,
                      "returns_max_rel_err": rel.max().item(),
                      "stats_card": sc.tolist(),
                      "stats_cpu": sp.tolist(),
                      "params_max_abs_err": (pc - pp).abs().max().item()}
    es, params = make_es("biped", device="cuda", pop=BIPED_CHECK_POP)
    g = torch.Generator(device="cuda").manual_seed(4)
    thetas = params + 0.1 * torch.randn(es.pop_size, es.dim, generator=g,
                                        device="cuda")
    states = es.reset_fn(es.pop_size, g)
    card = es.eval_fn(thetas, states).cpu()
    cpu_es, _ = make_es("biped", device="cpu", pop=BIPED_CHECK_POP)
    cpu = cpu_es.eval_fn(thetas.cpu(), states.cpu())
    rows["biped_400_steps"] = {"members": BIPED_CHECK_POP,
        "returns_agree": ((card - cpu).abs() <= ENV_RETURN_TOL
                          * cpu.abs().clamp(min=1.0)).float().mean().item(),
        "held": False}
    return rows


def phase_es_envs(torch):
    """bench.py --biped and --pixels as ``run_es(env=...)`` runs them
    (``make_es``, then ``run_fused``): ES_ENV_GENS generations against as
    many eager steps (``_es_fused``: stats exact, params bitwise), then
    the profiler's view and the CUDA-event time of one replayed
    generation. Then the other envs and policies, card against CPU."""
    from fiber_tpu_torch.entry import make_es

    start, rows = time.perf_counter(), {}
    for env in ("biped", "pixels"):
        t0 = time.perf_counter()
        es, params = make_es(env, device="cuda")
        row = _es_fused(torch, (es, params), ES_ENV_GENS)
        graph = es._fused_runner_cache[ES_ENV_GENS].graph
        row.update(pop=es.pop_size, dim=es.dim,
                   **_es_rates(torch, env, row),
                   replay=device_breakdown(torch, graph.replay),
                   replay_ms=cuda_ms(torch, graph.replay, reps=3),
                   seconds=time.perf_counter() - t0)
        rows[env] = row
        del es, params, graph
        torch.cuda.empty_cache()
    emit({"phase": "es_envs", "generations": ES_ENV_GENS, "envs": rows,
          "card_vs_cpu": _env_card_vs_cpu(torch),
          "phase_seconds": time.perf_counter() - start})


def phase_population_search(torch):
    """The population-search phases, with every kernel's launch count
    set to 0 before them and read after: none of these paths runs a TPU
    kernel's counterpart, in either package."""
    _reset_counts()
    phase_es_families(torch)
    phase_novelty(torch)
    phase_map_elites(torch)
    phase_ask_tell(torch)
    phase_device_map(torch)
    phase_poet(torch)
    phase_poet_mesh(torch)
    phase_checkpoint(torch)
    phase_es_envs(torch)
    counts = _counts()
    check(not any(counts.values()), f"kernels launched on the population "
          f"search paths: {counts}")
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # the host plane's log files go under this run's temporary directory
    os.environ.setdefault("FIBER_LOG_FILE", os.path.join(
        tempfile.gettempdir(), "fiber_tpu_torch.log"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    phase_build()
    fwd_rows = phase_kernels(torch, card)
    bwd_rows = phase_kernels_bwd(torch, card)
    ring_rows = phase_kernels_ring(torch, card)
    # The forward and decoding phases measure inference: no graph.
    with torch.no_grad():
        models = _lm_models(torch)
        fwd_launches, tokens, logits = phase_lm_forward(torch, models)
        phase_lm_generate(torch, models, tokens, logits)
    del models, tokens, logits
    torch.cuda.empty_cache()
    launches = phase_lm_train(torch)
    torch.cuda.empty_cache()
    phase_es(torch)
    # The mesh phases measure inference too.
    with torch.no_grad():
        ring_launches = phase_ring_attention(torch, card)
        grid_launches = phase_mesh_2d(torch, card)
        phase_lm_mesh(torch)
    mesh_train_launches = phase_lm_mesh_train(torch)
    torch.cuda.empty_cache()
    phase_es_mesh(torch)
    torch.cuda.empty_cache()
    search_launches = phase_population_search(torch)
    torch.cuda.empty_cache()
    pool_launches = phase_pool(torch)
    torch.cuda.empty_cache()
    host_plane_launches = phase_host_plane(torch)
    torch.cuda.empty_cache()
    host_plane_2_launches = phase_host_plane_2(torch, card)

    lm, lm_bwd = fwd_rows["lm_f32"], bwd_rows["lm_f32"]
    bf16, bf16_bwd = fwd_rows["attention_bf16"], bwd_rows["attention_bf16"]
    summary = [{
        "name": "flash_fwd", "engine": lm["engine"],
        "max_abs_err": lm["max_abs_err"],
        "ms": lm["ms"], "plain_ms": lm["plain_ms"],
        "bound_ms": lm["bound_ms"], "bound_by": lm["bound_by"],
        "library_ms": lm["library_ms"], "bound_engine": lm["bound_engine"],
        "launches_lm_forward": fwd_launches,
        "bfloat16": {k: bf16[k] for k in (
            "shape", "engine", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}}]
    for part in ("dq", "dkv"):
        row = lm_bwd[part]
        summary.append({
            "name": f"flash_bwd_{part}", "engine": lm_bwd[f"{part}_engine"],
            "max_abs_err": lm_bwd[f"{part}_max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "bound_engine": row["bound_engine"],
            # one SDPA backward call computes dq, dk and dv together
            "library_ms": lm_bwd["library_ms"], "library_covers": "dq+dkv",
            "bfloat16": {
                "shape": bf16_bwd["shape"],
                "engine": bf16_bwd[f"{part}_engine"],
                "max_abs_err": bf16_bwd[f"{part}_max_abs_err"],
                "library_ms": bf16_bwd["library_ms"],
                **{k: bf16_bwd[part][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by")}}})
    for entry in summary:
        entry.update(launches=launches[entry["name"]], path="lm_train",
                     launches_lm_mesh_train=mesh_train_launches[
                         entry["name"]],
                     lm_mesh_train_steps=TRAIN_STEPS + 1)
    ring = ring_rows["attention_bf16_kv"]
    summary.append({
        "name": "ring_exchange", "max_abs_err": ring["max_abs_err"],
        "ms": ring["ms"], "plain_ms": ring["plain_ms"],
        "bound_ms": ring["bound_ms"], "bound_by": ring["bound_by"],
        "library_ms": ring["library_ms"], "library_call": "torch.roll",
        "launches": ring_launches["ring_exchange"],
        "path": "ring_attention",
        "launches_lm_mesh_train": mesh_train_launches["ring_exchange"],
        "lm_mesh_train_steps": TRAIN_STEPS + 1})
    summary[0]["launches_mesh_2d"] = grid_launches["flash_fwd"]
    summary[-1]["launches_mesh_2d"] = grid_launches["ring_exchange"]
    for entry in summary:
        entry.update(route="cuda", source=SOURCES[entry["name"]],
                     replaces=REPLACES[entry["name"]],
                     launches_population_search=search_launches[
                         entry["name"]],
                     launches_pool=pool_launches[entry["name"]],
                     launches_host_plane=host_plane_launches[entry["name"]],
                     launches_host_plane_2=host_plane_2_launches[
                         entry["name"]])
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
