"""PGPE (Policy Gradients with Parameter-based Exploration) on the ES
step's skeleton: antithetic perturbations, centered-rank shaping, and a
per-parameter stddev that adapts beside the mean.

Counterpart of ``fiber_tpu/ops/pgpe.py``. The state is ``(mu, sigma)``,
both (dim,). A generation draws ``z`` (pairs, dim), evaluates
``[mu + sigma * z, mu - sigma * z]`` rank by rank in one ``eval_fn``
call over the rank-major population (as ``EvolutionStrategy.step``
does), ranks the gathered fitness, and ascends ``mu`` along the
antithetic differences and ``sigma`` along the symmetric sums on the
curvature term ``(eps^2 - sigma^2) / sigma``, each summed over ranks.
``run_fused`` replays one captured generation on CUDA.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from fiber_tpu_torch.ops import collectives
from fiber_tpu_torch.ops.es import _FusedRunMixin, centered_rank, run_steps
from fiber_tpu_torch.parallel.mesh import Mesh, mesh_for


class PGPE(_FusedRunMixin):
    """Antithetic PGPE with centered-rank shaping.

    ``eval_fn(thetas (m, dim), states (m, ...)) -> fitness (m,)`` and
    ``reset_fn(n, generator) -> states`` follow
    :class:`~fiber_tpu_torch.ops.es.EvolutionStrategy`. ``step(state)``
    advances one generation of ``state = (mu, sigma)``; its draws come
    from ``generator`` (seed 0 when omitted) unless it is handed them.
    """

    def __init__(
        self,
        eval_fn: Callable,
        reset_fn: Callable,
        dim: int,
        pop_size: int,
        sigma_init: float = 0.1,
        lr_mu: float = 0.05,
        lr_sigma: float = 0.01,
        sigma_floor: float = 1e-3,
        device=None,
        generator: Optional[torch.Generator] = None,
        mesh: Optional[Mesh] = None,
    ) -> None:
        self.mesh = mesh_for(device, mesh)
        self.device = self.mesh.device
        self.eval_fn = eval_fn
        self.reset_fn = reset_fn
        self.dim = int(dim)
        self.sigma_init = float(sigma_init)
        self.lr_mu = float(lr_mu)
        self.lr_sigma = float(lr_sigma)
        self.sigma_floor = float(sigma_floor)
        quantum = 2 * self.mesh.n_dev
        self.pop_size = max(quantum, (pop_size // quantum) * quantum)
        self.pairs = self.pop_size // 2
        self.pairs_per_dev = self.pop_size // quantum
        self.generator = generator or torch.Generator(
            device=self.device).manual_seed(0)

    def init_state(self, mu0=None) -> Tuple:
        """(mu, sigma) starting state on the device; ``mu0`` defaults to
        zeros."""
        mu = (torch.zeros(self.dim, device=self.device) if mu0 is None
              else torch.as_tensor(mu0, dtype=torch.float32,
                                   device=self.device))
        if mu.shape != (self.dim,):
            raise ValueError(f"mu0 shape {tuple(mu.shape)} != ({self.dim},)")
        return mu, torch.full((self.dim,), self.sigma_init,
                              device=self.device)

    def _generation(self, mu, sigma, z, states):
        mesh, n, k = self.mesh, self.mesh.n_dev, self.pairs_per_dev
        eps = (sigma * z).reshape(n, k, self.dim)
        thetas = torch.cat([mu + eps, mu - eps], dim=1)
        all_fit = self.eval_fn(thetas.reshape(self.pop_size, self.dim),
                               states).reshape(n, 2 * k)
        flat = all_fit.reshape(-1)
        ranks = centered_rank(flat).reshape(n, 2 * k)
        r_plus, r_minus = ranks[:, :k], ranks[:, k:]
        d_mu = collectives.psum(
            [(r_plus[r] - r_minus[r]) @ eps[r] for r in range(n)],
            mesh) / self.pop_size
        # sigma ascends the symmetric part on the curvature term; the
        # ranks are centered, so the baseline is already removed
        curv = (eps * eps - sigma * sigma) / sigma
        d_sigma = collectives.psum(
            [(r_plus[r] + r_minus[r]) @ curv[r] for r in range(n)],
            mesh) / self.pop_size
        new_mu = mu + self.lr_mu * d_mu
        new_sigma = torch.clamp_min(sigma + self.lr_sigma * d_sigma,
                                    self.sigma_floor)
        stats = torch.stack([flat.mean(), flat.max(), sigma.mean()])
        return new_mu, new_sigma, stats

    def _draw(self):
        """A generation's draws in order: z, states."""
        z = torch.randn(self.pairs, self.dim, generator=self.generator,
                        device=self.device)
        return z, self.reset_fn(self.pop_size, self.generator)

    def _device_step_fn(self, mu, sigma):
        """One generation with its own draws: the fused runner's body."""
        return self._generation(mu, sigma, *self._draw())

    @torch.no_grad()
    def step(self, state, z=None, states=None):
        """One generation: ((mu, sigma), stats) with stats the f32 tensor
        [mean fitness, max fitness, mean sigma]. ``z`` (pairs, dim) and
        ``states`` (pop, ...) are drawn from the generator when not
        given, rank-major as in ``EvolutionStrategy.step``."""
        mu, sigma = state
        if z is None or states is None:
            d_z, d_states = self._draw()
            z = d_z if z is None else z
            states = d_states if states is None else states
        if z.shape != (self.pairs, self.dim):
            raise ValueError(f"z shape {tuple(z.shape)} != "
                             f"({self.pairs}, {self.dim})")
        if states.shape[0] != self.pop_size:
            raise ValueError(f"{states.shape[0]} env states for a "
                             f"population of {self.pop_size}")
        new_mu, new_sigma, stats = self._generation(mu, sigma, z, states)
        return (new_mu, new_sigma), stats

    def run(self, state, generations: int):
        """N generations; returns (state, stats history)."""
        return run_steps(self.step, state, generations)
