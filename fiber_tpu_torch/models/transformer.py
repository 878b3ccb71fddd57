"""Tiny causal transformer LM: the forward pass, training and KV-cache
decoding.

Counterpart of ``TinyLM`` in ``fiber_tpu/models/transformer.py``:
embedding -> [RMSNorm -> attention -> residual -> RMSNorm -> MLP ->
residual] x L -> norm -> logits. Parameters keep the JAX tree's names
and layouts (weights ``(in, out)``, applied as ``x @ W``), so
:func:`fiber_tpu_torch.models.convert.tinylm_params_from_jax` loads a
JAX parameter tree unchanged.

``attention="flash"`` runs the flash-attention kernel once per layer,
and its two backward kernels once each per layer under autograd;
``"reference"`` runs the full-matrix oracle. ``apply`` and ``loss`` are
differentiable; :func:`make_train_step` with :func:`adamw` is the
counterpart of the JAX package's train step. The multi-device planes
(``"ring"``, ``"ulysses"``) are a later slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fiber_tpu_torch.device import resolve_device
from fiber_tpu_torch.ops.flash_attention import flash_attention
from fiber_tpu_torch.ops.ring_attention import reference_attention


def _normal(gen, dtype, device, *shape):
    t = 0.02 * torch.randn(*shape, generator=gen, dtype=dtype)
    return nn.Parameter(t.to(device))


def _const(value, n, dtype, device):
    return nn.Parameter(torch.full((n,), value, dtype=dtype, device=device))


class _Block(nn.Module):
    def __init__(self, dim, hidden, kv_dim, fused_qkv, device, dtype, gen):
        super().__init__()
        self.norm1 = _const(1.0, dim, dtype, device)
        if fused_qkv:
            self.wqkv = _normal(gen, dtype, device, dim, 3 * dim)
        else:
            self.wq = _normal(gen, dtype, device, dim, dim)
            self.wkv = _normal(gen, dtype, device, dim, 2 * kv_dim)
        self.wo = _normal(gen, dtype, device, dim, dim)
        self.norm2 = _const(1.0, dim, dtype, device)
        self.w1 = _normal(gen, dtype, device, dim, hidden)
        self.b1 = _const(0.0, hidden, dtype, device)
        self.w2 = _normal(gen, dtype, device, hidden, dim)
        self.b2 = _const(0.0, dim, dtype, device)


class TinyLM(nn.Module):
    """Causal byte/token LM. ``apply(tokens (max_seq,)) -> (max_seq,
    vocab)`` logits; ``loss(tokens)`` is the mean next-token
    cross-entropy; ``generate`` decodes with per-layer KV caches.

    ``pos`` is ``"learned"`` (absolute table) or ``"rope"`` (rotary, half
    split, base 10000). ``kv_heads`` < ``heads`` is grouped-query
    attention; ``window`` is a causal sliding window and needs
    ``attention="flash"``. Weights are drawn from ``generator`` (a
    ``torch.Generator``; seed 0 when omitted) and placed on ``device``.
    """

    def __init__(
        self,
        vocab: int = 256,
        dim: int = 64,
        heads: int = 8,
        layers: int = 2,
        max_seq: int = 256,
        mlp_mult: int = 4,
        attention: str = "flash",
        kv_heads: Optional[int] = None,
        pos: str = "learned",
        window: Optional[int] = None,
        device=None,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        if attention in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention={attention!r} is the multi-GPU slice of the "
                "port; use 'flash' or 'reference'")
        if attention not in ("flash", "reference"):
            raise ValueError(f"unknown attention {attention!r}")
        if pos not in ("learned", "rope"):
            raise ValueError(f"unknown positional scheme {pos!r}")
        if pos == "rope" and (dim // heads) % 2:
            raise ValueError("rope needs an even head_dim")
        if window is not None:
            if window < 1:
                raise ValueError(f"window must be >= 1, got {window}")
            if attention != "flash":
                raise ValueError(
                    "window= needs attention='flash' (the sliding "
                    "window is a kernel feature)")
        if kv_heads is not None and kv_heads < 1:
            raise ValueError(f"kv_heads must be >= 1, got {kv_heads}")
        kv_heads = kv_heads or heads
        if heads % kv_heads:
            raise ValueError(
                f"heads {heads} not divisible by kv_heads {kv_heads}")
        self.vocab = vocab
        self.dim = dim
        self.heads = heads
        self.kv_heads = kv_heads
        self.head_dim = dim // heads
        self.layers = layers
        self.max_seq = max_seq
        self.mlp_mult = mlp_mult
        self.attention = attention
        self.pos_scheme = pos
        self.window = window
        self.device = resolve_device(device)

        gen = generator or torch.Generator().manual_seed(0)
        dev = self.device
        self.embed = _normal(gen, dtype, dev, vocab, dim)
        self.out = _normal(gen, dtype, dev, dim, vocab)
        self.final_norm = _const(1.0, dim, dtype, dev)
        # the learned table keeps the JAX tree's name "pos"
        self.pos = (_normal(gen, dtype, dev, max_seq, dim)
                    if pos == "learned" else None)
        self.blocks = nn.ModuleList(
            _Block(dim, mlp_mult * dim, kv_heads * self.head_dim,
                   kv_heads == heads, dev, dtype, gen)
            for _ in range(layers))

    # ------------------------------------------------------------------
    def _attend(self, q, k, v):
        if self.attention == "flash":
            return flash_attention(q, k, v, causal=True, window=self.window)
        reps = q.shape[1] // k.shape[1]
        if reps > 1:  # GQA on the plain plane: repeat KV to full heads
            k = k.repeat_interleave(reps, dim=1)
            v = v.repeat_interleave(reps, dim=1)
        return reference_attention(q, k, v, causal=True)

    @staticmethod
    def _rms(x, g):
        return g * x / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True)
                                  + 1e-6)

    def _project_qkv(self, blk, h):
        if self.kv_heads == self.heads:
            return torch.chunk(h @ blk.wqkv, 3, dim=-1)
        q = h @ blk.wq
        k, v = torch.chunk(h @ blk.wkv, 2, dim=-1)
        return q, k, v

    def _rope_angles(self, positions):
        dh = self.head_dim
        inv = 1.0 / (10000.0 ** (torch.arange(
            0, dh, 2, device=self.device, dtype=torch.float32) / dh))
        ang = torch.as_tensor(positions, dtype=torch.float32,
                              device=self.device)[..., None] * inv
        return torch.cos(ang), torch.sin(ang)

    @staticmethod
    def _rope_rotate(x, cos, sin):
        """Half-split rotation; keeps x's dtype."""
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    def _block_tail(self, blk, x, attn_flat):
        x = x + attn_flat @ blk.wo
        h = self._rms(x, blk.norm2)
        # jax.nn.gelu's default is the tanh approximation
        return x + F.gelu(h @ blk.w1 + blk.b1, approximate="tanh") @ blk.w2 \
            + blk.b2

    def apply(self, tokens):
        """tokens (max_seq,) int -> logits (max_seq, vocab)."""
        S, H, Dh, KVH = self.max_seq, self.heads, self.head_dim, self.kv_heads
        tokens = torch.as_tensor(tokens, device=self.device)
        if tokens.shape != (S,):
            raise ValueError(
                f"tokens shape {tuple(tokens.shape)} != ({S},) (static "
                "shapes; pad shorter text)")
        x = self.embed[tokens]
        rope = None
        if self.pos is not None:
            x = x + self.pos
        else:
            cos, sin = self._rope_angles(torch.arange(S))
            rope = (cos[:, None, :], sin[:, None, :])
        for blk in self.blocks:
            h = self._rms(x, blk.norm1)
            q, k, v = self._project_qkv(blk, h)
            q = q.reshape(S, H, Dh)
            k = k.reshape(S, KVH, Dh)
            v = v.reshape(S, KVH, Dh)
            if rope is not None:
                q = self._rope_rotate(q, *rope)
                k = self._rope_rotate(k, *rope)
            attn = self._attend(q, k, v).reshape(S, -1)
            x = self._block_tail(blk, x, attn)
        x = self._rms(x, self.final_norm)
        return x @ self.out

    forward = apply

    def loss(self, tokens):
        """Mean next-token cross-entropy over positions 0..S-2."""
        tokens = torch.as_tensor(tokens, device=self.device)
        logits = self.apply(tokens)[:-1]
        return F.cross_entropy(logits.float(), tokens[1:].long())

    # ------------------------------------------------------------------
    # Inference: autoregressive decode with per-layer KV caches.
    # ------------------------------------------------------------------
    def new_caches(self):
        """Per-layer (k, v) caches of (max_seq, kv_heads, head_dim) in the
        parameters' dtype."""
        shape = (self.max_seq, self.kv_heads, self.head_dim)
        dtype = self.embed.dtype
        return [(torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in self.blocks]

    @torch.no_grad()
    def _decode_step(self, caches, pos: int, tok):
        """One position: writes row ``pos`` of every layer's cache (in
        place) and returns the logits. Attends to rows [0, pos] (inside
        the window, if any): the rows the JAX step leaves unmasked."""
        H, KVH, Dh = self.heads, self.kv_heads, self.head_dim
        group = H // KVH
        x = self.embed[tok]
        rope = None
        if self.pos is not None:
            x = x + self.pos[pos]
        else:
            rope = self._rope_angles(pos)
        lo = 0 if self.window is None else max(0, pos - self.window + 1)
        for blk, (k_cache, v_cache) in zip(self.blocks, caches):
            h = self._rms(x, blk.norm1)
            q, k, v = self._project_qkv(blk, h)
            q = q.reshape(KVH, group, Dh)
            k = k.reshape(KVH, Dh)
            if rope is not None:
                q = self._rope_rotate(q, *rope)
                k = self._rope_rotate(k, *rope)
            k_cache[pos] = k
            v_cache[pos] = v.reshape(KVH, Dh)
            kc, vc = k_cache[lo:pos + 1], v_cache[lo:pos + 1]
            s = torch.einsum("kgd,skd->kgs", q.float(), kc.float())
            p = torch.softmax(s / (Dh ** 0.5), dim=-1)
            attn = torch.einsum("kgs,skd->kgd", p.to(vc.dtype).float(),
                                vc.float())
            x = self._block_tail(blk, x, attn.to(x.dtype).reshape(-1))
        x = self._rms(x, self.final_norm)
        return x @ self.out

    @torch.no_grad()
    def generate(self, prompt, steps: int,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0):
        """Decode ``steps`` tokens after ``prompt`` (1-D ints). Greedy at
        temperature 0; otherwise samples from ``generator`` (a
        ``torch.Generator`` on the model's device). Returns the
        (len(prompt) + steps,) int64 token tensor."""
        prompt = torch.as_tensor(prompt, dtype=torch.long,
                                 device=self.device)
        n_prompt = int(prompt.shape[0])
        if n_prompt < 1:
            raise ValueError("prompt must have at least one token")
        if n_prompt + steps > self.max_seq:
            raise ValueError(
                f"prompt ({n_prompt}) + steps ({steps}) exceeds "
                f"max_seq ({self.max_seq})")
        if temperature > 0.0 and generator is None:
            raise ValueError("sampling (temperature > 0) needs a generator")

        def pick(logits):
            if temperature > 0.0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                return torch.multinomial(probs, 1, generator=generator)[0]
            return torch.argmax(logits)

        caches = self.new_caches()
        for pos in range(n_prompt):
            logits = self._decode_step(caches, pos, prompt[pos])
        out = [prompt]
        tok = pick(logits)
        for pos in range(n_prompt, n_prompt + steps):
            out.append(tok[None])
            if pos + 1 < n_prompt + steps:
                tok = pick(self._decode_step(caches, pos, tok))
        return torch.cat(out)


def adamw(params, lr: float) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` with ``optax.adamw``'s defaults written out:
    betas (0.9, 0.999), eps 1e-8 and weight decay 1e-4 on every
    parameter (one group; optax masks nothing). Torch's own default
    weight decay is 1e-2."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_train_step(model: TinyLM, optimizer: torch.optim.Optimizer,
                    batched: bool = False):
    """``step(tokens) -> loss``: one optimizer step on the mean next-token
    loss, the counterpart of the JAX package's ``make_train_step``. The
    JAX step returns new parameters and optimizer state; in PyTorch's
    idiom this one updates ``model``'s parameters and ``optimizer``'s
    state in place and returns the (detached) loss. With
    ``batched=True`` tokens is (B, max_seq) and the loss is the mean of
    the per-sequence losses (a loop where JAX vmaps)."""

    def step(tokens):
        optimizer.zero_grad(set_to_none=True)
        if batched:
            loss = torch.stack([model.loss(t) for t in tokens]).mean()
        else:
            loss = model.loss(tokens)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
