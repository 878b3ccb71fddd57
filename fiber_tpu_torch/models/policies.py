"""Policy networks for the ES workloads, as flat parameter vectors.

Counterpart of ``MLPPolicy`` in ``fiber_tpu/models/policies.py``. The
flat vector has the JAX layout (per layer: the (in, out) weight
row-major, then the bias), so a JAX ``MLPPolicy.init`` vector drives
both packages. Where JAX vmaps one policy over a population, the port
writes the population axis out: ``apply`` takes (pop, dim) parameters
and (pop, obs_dim) observations.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from fiber_tpu_torch.device import resolve_device


class MLPPolicy:
    """Tanh MLP: obs -> hidden* -> logits (f32)."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (32, 32)) -> None:
        self.obs_dim = obs_dim
        self.act_dim = act_dim
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
        gen = generator or torch.Generator().manual_seed(0)
        parts = []
        for n_in, n_out in zip(self.sizes[:-1], self.sizes[1:]):
            w = torch.randn(n_in, n_out, generator=gen) / n_in ** 0.5
            parts += [w.reshape(-1), torch.zeros(n_out)]
        return torch.cat(parts).to(resolve_device(device))

    def apply(self, flat_params, obs):
        """Logits (pop, act_dim) for parameters (pop, dim) and
        observations (pop, obs_dim)."""
        pop = flat_params.shape[0]
        x = obs.unsqueeze(1)                                  # (pop, 1, in)
        offset = 0
        n_layers = len(self.sizes) - 1
        for i in range(n_layers):
            n_in, n_out = self.sizes[i], self.sizes[i + 1]
            w = flat_params[:, offset:offset + n_in * n_out].reshape(
                pop, n_in, n_out)
            offset += n_in * n_out
            b = flat_params[:, offset:offset + n_out].unsqueeze(1)
            offset += n_out
            x = torch.bmm(x, w) + b
            if i < n_layers - 1:
                x = torch.tanh(x)
        return x.squeeze(1).float()

    def act(self, flat_params, obs):
        """Deterministic discrete actions (pop,): the first argmax."""
        return torch.argmax(self.apply(flat_params, obs), dim=-1)
