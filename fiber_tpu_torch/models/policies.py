"""Policy networks for the ES workloads, as flat parameter vectors.

Counterpart of ``MLPPolicy``, ``ConvPolicy`` and ``GRUPolicy`` in
``fiber_tpu/models/policies.py``. The flat vectors have the JAX layouts
(an MLP layer: the (in, out) weight row-major, then the bias; a
convolution: the HWIO kernel, then the bias; the GRU: its gates in the
JAX order), so a JAX ``init`` vector drives both packages. Where JAX
vmaps one policy over a population, the port writes the population axis
out: ``apply`` takes (pop, dim) parameters and a batch of observations,
every member with its own weights, as batched products (``torch.bmm``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fiber_tpu_torch.device import resolve_device


def _compute_dtype(explicit: Optional[str]):
    """The policy's product precision: the explicit name, else
    ``FIBER_POLICY_DTYPE`` (read at every ``apply``, as JAX reads it at
    trace time), else None (f32). Parameters and logits stay f32 at
    the boundary."""
    name = explicit or os.environ.get("FIBER_POLICY_DTYPE", "")
    return getattr(torch, name) if name else None


def _draw(shapes, generator, device) -> torch.Tensor:
    """A flat vector of ``(shape, fan_in)`` parts: weights ``N(0, 1 /
    fan_in)`` and, where fan_in is None, zeros; drawn on the CPU from
    ``generator`` (seed 0 when omitted) and placed on ``device``."""
    gen = generator or torch.Generator().manual_seed(0)
    parts = [torch.zeros(shape) if fan_in is None
             else torch.randn(shape, generator=gen) / fan_in ** 0.5
             for shape, fan_in in shapes]
    return torch.cat([p.reshape(-1) for p in parts]).to(
        resolve_device(device))


def _take(flat, offset: int, shape) -> Tuple[torch.Tensor, int]:
    """The (pop, *shape) block of every member's vector at ``offset``,
    and the offset after it."""
    n = 1
    for s in shape:
        n *= s
    return (flat[:, offset:offset + n].reshape(flat.shape[0], *shape),
            offset + n)


def _dense(x, w, b):
    """x (pop, in) @ w (pop, in, out) + b (pop, out), member by member."""
    return torch.bmm(x.unsqueeze(1), w).squeeze(1) + b


class MLPPolicy:
    """Tanh MLP: obs -> hidden* -> logits (f32). ``compute_dtype`` (or
    ``FIBER_POLICY_DTYPE``) runs the products, bias adds and tanh in
    that precision, e.g. ``"bfloat16"``."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (32, 32),
                 compute_dtype: Optional[str] = None) -> None:
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.compute_dtype = compute_dtype
        self.sizes = (obs_dim, *hidden, act_dim)
        self.dim = sum(
            self.sizes[i] * self.sizes[i + 1] + self.sizes[i + 1]
            for i in range(len(self.sizes) - 1)
        )

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
        """Flat parameter vector (dim,): weights N(0, 1/fan_in), zero
        biases, drawn on the CPU from ``generator`` (seed 0 when
        omitted) and placed on ``device``."""
        shapes = []
        for n_in, n_out in zip(self.sizes[:-1], self.sizes[1:]):
            shapes += [((n_in, n_out), n_in), ((n_out,), None)]
        return _draw(shapes, generator, device)

    def apply(self, flat_params, obs):
        """Logits (pop, act_dim) f32 for parameters (pop, dim) and
        observations (pop, obs_dim)."""
        dt = _compute_dtype(self.compute_dtype)
        x = obs
        if dt is not None:
            x, flat_params = x.to(dt), flat_params.to(dt)
        offset = 0
        n_layers = len(self.sizes) - 1
        for i in range(n_layers):
            w, offset = _take(flat_params, offset,
                              (self.sizes[i], self.sizes[i + 1]))
            b, offset = _take(flat_params, offset, (self.sizes[i + 1],))
            x = _dense(x, w, b)
            if i < n_layers - 1:
                x = torch.tanh(x)
        return x.float()

    def act(self, flat_params, obs):
        """Deterministic discrete actions (pop,): the first argmax."""
        return torch.argmax(self.apply(flat_params, obs), dim=-1)


def _same_pad(n: int, k: int = 3, stride: int = 2) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one axis: the total that makes
    ``ceil(n / stride)`` outputs, the smaller half before (24 -> 12 at
    stride 2 pads 0 before and 1 after)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class ConvPolicy:
    """Small conv policy for image observations (Atari-style ES): 3x3
    stride-2 ``SAME`` convolutions with tanh in NHWC, then a tanh dense
    layer and the logits. Each member's convolution is an im2col of its
    image, patches in (kh, kw, cin) order to match the HWIO kernel,
    times that kernel: one ``torch.bmm`` over the population."""

    def __init__(self, obs_shape: Tuple[int, int, int], act_dim: int,
                 channels: Sequence[int] = (16, 32),
                 hidden: int = 128,
                 compute_dtype: Optional[str] = None) -> None:
        self.obs_shape = tuple(obs_shape)  # (H, W, C)
        self.act_dim = act_dim
        self.channels = tuple(channels)
        self.hidden = hidden
        self.compute_dtype = compute_dtype
        h, w, c = obs_shape
        self._specs = []
        in_c = c
        for out_c in self.channels:
            self._specs.append(("conv", (3, 3, in_c, out_c)))
            in_c = out_c
            h, w = (h + 1) // 2, (w + 1) // 2  # stride-2 convs
        self._flat_len = h * w * in_c
        self._specs.append(("dense", (self._flat_len, hidden)))
        self._specs.append(("dense", (hidden, act_dim)))
        self.dim = 0
        for _, shape in self._specs:
            n = 1
            for s in shape:
                n *= s
            self.dim += n + shape[-1]

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
        """Flat parameter vector (dim,): every kernel N(0, 1/fan_in)
        with fan_in its size over the output channels, zero biases."""
        shapes = []
        for _, shape in self._specs:
            fan_in = 1
            for s in shape[:-1]:
                fan_in *= s
            shapes += [(shape, fan_in), ((shape[-1],), None)]
        return _draw(shapes, generator, device)

    @staticmethod
    def _conv(x, w, b):
        """tanh of the stride-2 ``SAME`` convolution of images x (pop, H,
        W, cin) with each member's kernel w (pop, 3, 3, cin, cout)."""
        pop, h, wd, cin = x.shape
        (t, bo), (l, r) = _same_pad(h), _same_pad(wd)
        x = F.pad(x, (0, 0, l, r, t, bo))
        # (pop, oh, ow, cin, kh, kw) -> patches in (kh, kw, cin) order
        patches = x.unfold(1, 3, 2).unfold(2, 3, 2).permute(0, 1, 2, 4, 5, 3)
        oh, ow = patches.shape[1], patches.shape[2]
        y = torch.bmm(patches.reshape(pop, oh * ow, 9 * cin),
                      w.reshape(pop, 9 * cin, -1))
        return torch.tanh(y + b.unsqueeze(1)).reshape(pop, oh, ow, -1)

    def apply(self, flat_params, obs):
        """Logits (pop, act_dim) f32 for parameters (pop, dim) and NHWC
        images (pop, H, W, C)."""
        dt = _compute_dtype(self.compute_dtype)
        x = obs
        if dt is not None:
            x, flat_params = x.to(dt), flat_params.to(dt)
        offset = 0
        n = len(self._specs)
        for i, (kind, shape) in enumerate(self._specs):
            w, offset = _take(flat_params, offset, shape)
            b, offset = _take(flat_params, offset, (shape[-1],))
            if kind == "conv":
                x = self._conv(x, w, b)
            else:
                # NHWC flattens in (h, w, c) order, the dense rows' order
                x = _dense(x.reshape(x.shape[0], -1), w, b)
                if i < n - 1:
                    x = torch.tanh(x)
        return x.float()

    def act(self, flat_params, obs):
        """Deterministic discrete actions (pop,): the first argmax."""
        return torch.argmax(self.apply(flat_params, obs), dim=-1)


class GRUPolicy:
    """Single-layer GRU with a linear readout, as flat parameter vectors:
    the recurrent family for partially observable ES tasks. The carry
    is (pop, hidden); ``act_step(flat_params, carry, obs) -> (carry',
    actions)`` advances every member one step, and
    ``models.envs.rollout_recurrent`` runs an episode."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: int = 32) -> None:
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hidden = hidden
        # 3 gates x (W: obs->h, U: h->h, b) + readout (h->act, b)
        self.dim = (
            3 * (obs_dim * hidden + hidden * hidden + hidden)
            + hidden * act_dim + act_dim
        )

    def _shapes(self):
        """(shape, fan_in) of every part, in the JAX order: the z gate,
        the r gate and the candidate, each (W, U, b); the readout."""
        o, h, a = self.obs_dim, self.hidden, self.act_dim
        return ([((o, h), o), ((h, h), h), ((h,), None)] * 3
                + [((h, a), h), ((a,), None)])

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
        """Flat parameter vector (dim,): weights N(0, 1/fan_in), zero
        biases."""
        return _draw(self._shapes(), generator, device)

    def init_carry(self, n: int, device=None) -> torch.Tensor:
        """The zero hidden state (n, hidden) of n members."""
        return torch.zeros(n, self.hidden, device=resolve_device(device))

    def _unpack(self, flat):
        out, offset = [], 0
        for shape, _ in self._shapes():
            part, offset = _take(flat, offset, shape)
            out.append(part)
        return out

    def step(self, flat_params, carry, obs):
        """(carry' (pop, hidden), logits (pop, act_dim))."""
        (wz, uz, bz, wr, ur, br, wh, uh, bh, wo, bo) = \
            self._unpack(flat_params)

        def mm(x, w):
            return torch.bmm(x.unsqueeze(1), w).squeeze(1)

        z = torch.sigmoid(mm(obs, wz) + mm(carry, uz) + bz)
        r = torch.sigmoid(mm(obs, wr) + mm(carry, ur) + br)
        cand = torch.tanh(mm(obs, wh) + mm(r * carry, uh) + bh)
        new_carry = (1.0 - z) * carry + z * cand
        return new_carry, mm(new_carry, wo) + bo

    def act_step(self, flat_params, carry, obs):
        """(carry', actions (pop,)): the first argmax of the logits."""
        new_carry, logits = self.step(flat_params, carry, obs)
        return new_carry, torch.argmax(logits, dim=-1)
