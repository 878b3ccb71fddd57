"""OpenAI-ES over a mesh of ranks: antithetic perturbation, population
rollout, centered-rank shaping, gradient estimate and update.

Counterpart of ``fiber_tpu/ops/es.py`` (``apply_es_update``,
``centered_rank``, ``EvolutionStrategy.step``, ``run`` and
``reset_optimizer``). The JAX step is one SPMD program over the mesh;
on the port's single-controller mesh (``parallel/mesh.py``) its
per-device body is a loop over ranks: every rank evaluates its own
antithetic half-population, fitness is all-gathered rank-major before
ranking, and the per-rank gradients are summed (``ops/collectives``).
``run_fused`` and ``AskTellES`` are later slices of the port.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fiber_tpu_torch.device import resolve_device
from fiber_tpu_torch.ops import collectives
from fiber_tpu_torch.parallel.mesh import Mesh, make_mesh


def apply_es_update(params, grad, m, v, t, *, lr, wd, adam,
                    b1=0.9, b2=0.999, eps=1e-8):
    """Ascent step: SGD or bias-corrected Adam on the estimated gradient,
    with decoupled weight decay. Returns ``(new_params, m, v, t)``; in
    SGD mode the moment slots pass through untouched."""
    if adam:
        t = t + 1.0
        m = b1 * m + (1 - b1) * grad
        v = b2 * v + (1 - b2) * grad * grad
        m_hat = m / (1 - b1 ** t)
        v_hat = v / (1 - b2 ** t)
        update = lr * m_hat / (torch.sqrt(v_hat) + eps)
    else:
        update = lr * grad
    return params + update - lr * wd * params, m, v, t


def centered_rank(x):
    """Fitness -> centered ranks in [-0.5, 0.5]. Ties keep their order
    of appearance (a stable sort, as ``jnp.argsort``): CartPole returns
    are integers full of ties, and another tie order is another
    gradient."""
    n = x.shape[0]
    order = torch.argsort(x, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(n, device=x.device)
    return ranks.float() / (n - 1) - 0.5


class EvolutionStrategy:
    """OpenAI-ES with antithetic sampling and rank shaping.

    ``eval_fn(thetas (m, dim), env_states (m, ...)) -> (m,)`` fitness
    evaluates one rank's population at once;
    ``reset_fn(n, generator) -> env_states`` draws initial states. Noise
    and states come from ``generator`` (a ``torch.Generator`` on the
    device; seed 0 when omitted) unless a step is handed them.

    ``mesh`` (n ranks; one rank on ``device`` when omitted) splits the
    population: rank r holds ``pop / (2n)`` antithetic pairs, evaluated
    as ``[params + sigma * eps_r, params - sigma * eps_r]``. After a
    step, ``last_fitness`` is the gathered (n, pop / n) fitness and
    ``last_grad`` the gradient estimate.
    """

    def __init__(
        self,
        eval_fn: Callable,
        reset_fn: Callable,
        dim: int,
        pop_size: int,
        sigma: float = 0.1,
        lr: float = 0.02,
        weight_decay: float = 0.0,
        optimizer: str = "sgd",
        device=None,
        generator: Optional[torch.Generator] = None,
        mesh: Optional[Mesh] = None,
    ) -> None:
        if optimizer not in ("sgd", "adam"):
            raise ValueError(f"unknown optimizer {optimizer!r}")
        if mesh is None:
            mesh = make_mesh(device)
        elif device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's device "
                             f"{mesh.device}")
        self.mesh = mesh
        self.device = mesh.device
        self.eval_fn = eval_fn
        self.reset_fn = reset_fn
        self.dim = dim
        self.sigma = float(sigma)
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.optimizer = optimizer
        # pop must be even (antithetic pairs) and divisible by the mesh
        quantum = 2 * self.mesh.n_dev
        self.pop_size = max(quantum, (pop_size // quantum) * quantum)
        self.pairs = self.pop_size // 2
        self.pairs_per_dev = self.pop_size // quantum
        self.generator = generator or torch.Generator(
            device=self.device).manual_seed(0)
        self._opt_state = None  # adam (m, v, t)
        self.last_fitness = None
        self.last_grad = None

    def _ensure_opt_state(self, params):
        if self.optimizer != "adam":
            return None, None, 0.0
        if params.shape != (self.dim,):
            raise ValueError(f"params shape {tuple(params.shape)} != "
                             f"({self.dim},)")
        if self._opt_state is None:
            zeros = torch.zeros_like(params)
            self._opt_state = (zeros, zeros, 0.0)
        return self._opt_state

    def reset_optimizer(self) -> None:
        """Drops the Adam state (m, v, t), so that the next step starts it
        anew: one instance tracks one population's state, so call this
        when switching populations."""
        self._opt_state = None

    @torch.no_grad()
    def step(self, params, eps=None, states=None):
        """One generation: (new_params, stats) with stats the f32 tensor
        [mean fitness, max fitness, mean over ranks of each rank's mean
        fitness]. ``eps`` (pairs, dim) and ``states`` (pop, ...) are
        drawn from the generator when not given; both are rank-major:
        rank r takes eps rows ``r * k .. (r + 1) * k`` (k pairs a rank)
        and state rows ``2 * r * k .. 2 * (r + 1) * k``, its "+" members
        first. Ties in the integer returns rank in that order."""
        if eps is None:
            eps = torch.randn(self.pairs, self.dim,
                              generator=self.generator, device=self.device)
        if states is None:
            states = self.reset_fn(self.pop_size, self.generator)
        if eps.shape != (self.pairs, self.dim):
            raise ValueError(f"eps shape {tuple(eps.shape)} != "
                             f"({self.pairs}, {self.dim})")
        if states.shape[0] != self.pop_size:
            raise ValueError(f"{states.shape[0]} env states for a "
                             f"population of {self.pop_size}")
        m, v, t = self._ensure_opt_state(params)
        mesh, k = self.mesh, self.pairs_per_dev
        eps_r, fit_r = [], []
        for r, dev in enumerate(mesh.devices):
            e = eps[r * k:(r + 1) * k].to(dev)
            p = params.to(dev)
            thetas = torch.cat([p + self.sigma * e, p - self.sigma * e])
            eps_r.append(e)
            fit_r.append(self.eval_fn(
                thetas, states[2 * r * k:2 * (r + 1) * k].to(dev)))
        # rank shaping over the whole population, gathered rank-major
        all_fit = collectives.all_gather(fit_r, mesh)
        flat = all_fit.reshape(-1)
        ranks = centered_rank(flat).reshape(all_fit.shape)
        g_r = [(ranks[r, :k] - ranks[r, k:]).to(e.device) @ e
               for r, e in enumerate(eps_r)]
        grad = collectives.psum(g_r, mesh) / (self.pop_size * self.sigma)
        new_params, m, v, t = apply_es_update(
            params, grad, m, v, t, lr=self.lr, wd=self.weight_decay,
            adam=self.optimizer == "adam")
        if self.optimizer == "adam":
            self._opt_state = (m, v, t)
        stats = torch.stack([flat.mean(), flat.max(), collectives.pmean(
            [f.mean() for f in fit_r], mesh)])
        self.last_fitness, self.last_grad = all_fit, grad
        return new_params, stats

    def run(self, params, generations: int, log_every: int = 0):
        """N generations; returns (params, history of (gen, mean, max))
        logged every ``log_every`` generations and at the last."""
        history = []
        for gen in range(generations):
            params, stats = self.step(params)
            if log_every and (gen % log_every == 0
                              or gen == generations - 1):
                mean, best = stats[:2].tolist()
                history.append((gen, mean, best))
        return params, history
