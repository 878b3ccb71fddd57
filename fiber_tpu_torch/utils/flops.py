"""Analytic operation counts, the H100's published peaks and MFU.

The counters are a copy of ``fiber_tpu/utils/flops.py``
(``matmul_flops``, ``attention_flops``, ``tinylm_flops_per_step``,
``ENV_STEP_FLOPS``, ``policy_flops_per_action``,
``rollout_flops_per_eval``, ``es_flops_per_gen``) under the same
conventions: a (m, k) x (k, n) product is ``2*m*k*n`` operations,
attention counts its two S x S products (causal halves them, a window
counts each row's min(pos+1, window) keys), softmax is not counted,
training is 3x the forward, and a rollout counts its policy's products
plus a few dozen scalar operations of physics a step.
``ring_exchange_bytes`` is the port's own count of the bytes one ring
rotation moves.

MFU follows the JAX package's convention: model FLOP/s over the bf16
dense matmul peak of the cards the work ran on (:func:`mfu`,
:func:`peak_report`), with ``FIBER_PEAK_FLOPS`` (FLOP/s a card)
overriding the table.

The peaks are one NVIDIA H100 SXM's, dense, from NVIDIA's data sheet;
they assume the card's full 700 W power limit. :func:`bound_ms` is the
least time the card could take for a piece of work: the larger of its
bytes over the memory rate and its operations over the fastest rate the
card has for inputs of their type (:func:`op_peak`: for f32 inputs that
is 3xTF32 on the tensor cores, not FMA on the CUDA cores).
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

import torch

#: peak operations per second by the type that does them
H100_PEAK_FLOPS = {
    "float32": 67e12,     # CUDA-core FMA, outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "fp8": 1979e12,
}
#: bf16 dense peak by substring of the lowercased CUDA device name (first
#: match wins): the MFU denominator
_PEAK_BY_KIND = (
    ("h100", H100_PEAK_FLOPS["bfloat16"]),
)
#: Approximate scalar FLOPs per env.step for the shipped envs (physics
#: only, excluding the policy). PixelChase includes its 24x24 render.
ENV_STEP_FLOPS = {
    "CartPole": 50.0,
    "ParamCartPole": 60.0,
    "Pendulum": 40.0,
    "PixelChase": 3e3,
    "DeceptiveMaze": 60.0,
    "ParamHillWalker": 200.0,
    "ParamBipedWalker": 600.0,
}
#: HBM3 bytes per second
H100_MEM_BYTES_PER_S = 3.35e12
#: TF32 products per f32 product under 3xTF32: each operand split into
#: big = tf32(x) and small = tf32(x - big), summing big*big + big*small +
#: small*big in f32, which keeps f32's precision where one TF32 product
#: does not
TF32_PASSES = 3


def matmul_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def attention_flops(seq: int, heads: int, head_dim: int,
                    causal: bool = True, train: bool = False,
                    window: Optional[int] = None) -> float:
    """QK^T + P.V for one head stack at full sequence length. With a
    causal sliding ``window`` each position attends min(pos+1, window)
    keys instead of pos+1."""
    if window is not None:
        if not causal:
            raise ValueError("windowed attention_flops requires causal")
        w = min(window, seq)
        kv_total = w * (w + 1) / 2 + (seq - w) * w
        fwd = 2 * 2 * kv_total * head_dim * heads
        return fwd * (3.0 if train else 1.0)
    fwd = 2 * matmul_flops(seq, head_dim, seq) * heads
    if causal:
        fwd /= 2
    return fwd * (3.0 if train else 1.0)


def attention_bwd_flops(seq: int, heads: int, head_dim: int,
                        causal: bool = True, window: Optional[int] = None,
                        part: str = "dq") -> float:
    """Operations of one backward kernel, for its bound: only the S x S x
    D products its function needs, counted, halved by causality and
    windowed as :func:`attention_flops` counts the forward's two. ``dq``
    needs s, dp and dq (3 products, 1.5x the forward); ``dkv`` needs s,
    dp, dv and dk (4 products, 2x the forward). The exponentials and the
    elementwise ds are not counted, as softmax is not in the forward.
    :func:`tinylm_flops_per_step` keeps the JAX package's 3x convention
    for model FLOP/s instead."""
    products = {"dq": 3, "dkv": 4}[part]
    return attention_flops(seq, heads, head_dim, causal=causal,
                           window=window) * products / 2


def tinylm_flops_per_step(model, seq: int, train: bool = True) -> float:
    """One TinyLM forward (or train: fwd + 2x bwd) at ``seq`` tokens:
    the per-block projections, attention and the unembedding."""
    d, h = model.dim, model.mlp_mult * model.dim
    kvh = getattr(model, "kv_heads", model.heads)
    if kvh == model.heads:
        proj = matmul_flops(seq, d, 3 * d)
    else:
        kv_dim = kvh * model.head_dim
        proj = matmul_flops(seq, d, d) + matmul_flops(seq, d, 2 * kv_dim)
    per_block = (
        proj
        + matmul_flops(seq, d, d)
        + matmul_flops(seq, d, h)
        + matmul_flops(seq, h, d)
        + attention_flops(seq, model.heads, model.head_dim, causal=True,
                          window=getattr(model, "window", None))
    )
    fwd = model.layers * per_block + matmul_flops(seq, d, model.vocab)
    return fwd * (3.0 if train else 1.0)


def ring_exchange_bytes(arrays) -> int:
    """Bytes one ``ring_exchange`` moves: every (rank, array) block read
    once and written once. ``arrays[j][r]`` is array j on rank r; the
    bound is ``bound_ms(0, ring_exchange_bytes(arrays), dtype)``."""
    return sum(2 * x.nbytes for per_rank in arrays for x in per_rank)


def op_peak(op_type: str):
    """(operations per second, engine): the fastest rate the card has for
    operations on ``op_type`` inputs. For float32 that is the lesser time
    of FMA on the CUDA cores (67 TFLOP/s) and 3xTF32 on the tensor cores
    (``TF32_PASSES`` TF32 products per f32 product: 495 / 3 = 165 TFLOP/s),
    so "3xtf32"; every other type runs at its own tensor-core peak."""
    if op_type == "float32":
        engines = {"cuda cores": H100_PEAK_FLOPS["float32"],
                   "3xtf32": H100_PEAK_FLOPS["tf32"] / TF32_PASSES}
        engine = max(engines, key=engines.get)
        return engines[engine], engine
    return H100_PEAK_FLOPS[op_type], "tensor cores"


def bound_ms(flops: float, nbytes: float, op_type: str):
    """(least time in ms, "bytes" or "operations") for work of ``flops``
    operations on ``op_type`` inputs that must move ``nbytes``; the
    operations run at :func:`op_peak`'s rate."""
    t_ops = flops / op_peak(op_type)[0]
    t_mem = nbytes / H100_MEM_BYTES_PER_S
    if t_ops >= t_mem:
        return t_ops * 1e3, "operations"
    return t_mem * 1e3, "bytes"


def policy_flops_per_action(policy) -> float:
    """FLOPs for one forward pass of a shipped policy network."""
    name = type(policy).__name__
    if name == "MLPPolicy":
        return sum(matmul_flops(1, a, b)
                   for a, b in zip(policy.sizes[:-1], policy.sizes[1:]))
    if name == "GRUPolicy":
        o, h, a = policy.obs_dim, policy.hidden, policy.act_dim
        # 3 gates: each (obs + hidden) -> hidden, plus the output head.
        return 3 * (matmul_flops(1, o, h) + matmul_flops(1, h, h)) \
            + matmul_flops(1, h, a)
    if name == "ConvPolicy":
        total = 0.0
        h, w, _ = policy.obs_shape
        for kind, shape in policy._specs:
            if kind == "conv":
                kh, kw, in_c, out_c = shape
                h, w = (h + 1) // 2, (w + 1) // 2  # stride-2 output
                total += matmul_flops(h * w, kh * kw * in_c, out_c)
            else:
                total += matmul_flops(1, *shape)
        return total
    raise ValueError(f"no FLOP counter for policy {name!r}")


def rollout_flops_per_eval(policy, env_name: str, steps: int) -> float:
    """One episode: ``steps`` policy actions plus env physics."""
    return steps * (policy_flops_per_action(policy)
                    + ENV_STEP_FLOPS.get(env_name, 0.0))


def es_flops_per_gen(policy, env_name: str, steps: int, pop: int,
                     dim: int) -> float:
    """One ES generation: ``pop`` rollouts plus the update: noise draw,
    perturbation, the fitness-weighted combine (a (1, pop) x (pop, dim)
    product) and the parameter step."""
    return (pop * rollout_flops_per_eval(policy, env_name, steps)
            + matmul_flops(1, pop, dim) + 4.0 * pop * dim)


#: device kinds already reported as missing from the table (one stderr
#: line a kind a process)
_reported_miss: set = set()


def _device_kind(device) -> str:
    """The lowercased CUDA device name, or the device type ("cpu")."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device).lower()
    return device.type


def _resolve_peak(device):
    """(kind, peak FLOP/s or None, the auditable row or None): the one
    place both :func:`device_peak_flops` and :func:`peak_report` read,
    so the reported row is always the peak used."""
    kind = _device_kind(device)
    env = os.environ.get("FIBER_PEAK_FLOPS")
    if env:
        peak = float(env)
        return kind, peak, f"env:{peak:.4g}"
    if torch.device(device).type != "cuda":
        return kind, None, None
    for sub, peak in _PEAK_BY_KIND:
        if sub in kind:
            return kind, peak, f"{sub}:{peak:.4g}"
    return kind, None, None


def device_peak_flops(device) -> Optional[float]:
    """bf16 dense peak FLOP/s of the card ``device`` names, or None: on
    the CPU (an MFU against a CPU "peak" would be noise), and for a CUDA
    card that no row of the table matches, which is reported on stderr
    once a kind, since a quiet None would hide a card the table lacks."""
    kind, peak, _ = _resolve_peak(device)
    if (peak is None and torch.device(device).type == "cuda"
            and kind not in _reported_miss):
        _reported_miss.add(kind)
        print(f"FLOPS PEAK TABLE MISS: device_kind={kind!r} matched no "
              f"_PEAK_BY_KIND row; mfu will be null - set "
              f"FIBER_PEAK_FLOPS to override", file=sys.stderr, flush=True)
    return peak


def peak_report(devices: Sequence) -> dict:
    """The device kind a measurement ran on and the peak row (or the
    override) it resolved to, so that an MFU is auditable."""
    kind, _, row = _resolve_peak(devices[0])
    return {"device_kind": kind, "peak_row": row}


def mfu(flops_per_sec: float, devices: Sequence) -> Optional[float]:
    """``flops_per_sec`` as a fraction of the summed peak of the distinct
    cards in ``devices`` (a mesh's ranks: several ranks on one card
    share its peak). None when any card's peak is unknown."""
    total = 0.0
    for d in dict.fromkeys(torch.device(d) for d in devices):
        peak = device_peak_flops(d)
        if not peak:
            return None
        total += peak
    return flops_per_sec / total if total else None
