"""CMA-ES, separable and full-covariance, on the ES step's skeleton.

Counterpart of ``fiber_tpu/ops/cma.py`` (``_CMABase``, ``SepCMAES``,
``CMAES``), with Hansen's default constants. A generation draws ``z``
(lam, dim), maps it to ``y ~ N(0, C)``, evaluates ``m + sigma * y`` in
one ``eval_fn`` call over the rank-major population, ranks the gathered
fitness best first (a stable sort: CartPole returns are integers full
of ties, and the order of ties is the order of the weights), and sums
each rank's weighted moments (``<y>_w``, ``<z>_w`` and the rank-mu
moment) over the ranks before the path, covariance and step-size
updates.

* ``SepCMAES`` keeps the diagonal of C: every update is elementwise,
  O(dim) a generation, with the separable model's faster learning rates.
* ``CMAES`` keeps the full (dim, dim) C and factors it every generation
  with ``torch.linalg.eigh``. On CUDA that call checks its result on the
  host, which a CUDA-graph capture refuses, so ``run_fused`` runs the
  eigh outside the graph before every replay (``_eager_prep``; see
  ``ops/es.build_fused_runner``) and captures the rest of the
  generation, which reads B and D from static slots.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from fiber_tpu_torch.ops import collectives
from fiber_tpu_torch.ops.es import _FusedRunMixin, run_steps
from fiber_tpu_torch.parallel.mesh import Mesh, mesh_for


class _CMABase(_FusedRunMixin):
    """Population quantisation over the mesh, Hansen's constants and the
    generation. Subclasses give the covariance model four hooks:

    * ``_prep_cov(C) -> prep`` (a tuple of tensors): the generation's
      factorisation (``(C,)`` for the diagonal, ``(C_sym, B, D)`` for
      the full model);
    * ``_sample(z, prep) -> y``: N(0, I) draws to N(0, C);
    * ``_whiten(zw, prep) -> C^{-1/2} <y>_w``;
    * ``_cov_moment(w, y)`` (summed over ranks) and ``_cov_update(prep,
      moment, p_c, h_sigma) -> new C``.

    ``sep_scaling=True`` takes the separable model's learning-rate boost
    ((n + 2) / 3; Ros & Hansen 2008).
    """

    def __init__(self, eval_fn: Callable, reset_fn: Callable, dim: int,
                 pop_size: int, sigma_init: float, sep_scaling: bool,
                 device=None, generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None) -> None:
        self.mesh = mesh_for(device, mesh)
        self.device = self.mesh.device
        self.eval_fn = eval_fn
        self.reset_fn = reset_fn
        self.dim = int(dim)
        self.sigma_init = float(sigma_init)
        n_dev = self.mesh.n_dev
        # at least 2 a rank, so that mu = lam // 2 >= 1
        self.pop_size = max(2 * n_dev, (pop_size // n_dev) * n_dev)
        self.lam_per_dev = self.pop_size // n_dev
        self.generator = generator or torch.Generator(
            device=self.device).manual_seed(0)

        lam, n = self.pop_size, self.dim
        mu = lam // 2
        w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
        w = w / w.sum()
        self.mu = mu
        self.weights = w
        self.mu_eff = float(1.0 / (w ** 2).sum())
        # the weight of each rank, best first; 0 past mu
        self.w_table = torch.zeros(lam, device=self.device)
        self.w_table[:mu] = torch.as_tensor(w, dtype=torch.float32)

        me = self.mu_eff
        self.c_sigma = (me + 2.0) / (n + me + 5.0)
        self.d_sigma = (1.0 + 2.0 * max(0.0, math.sqrt((me - 1.0) /
                                                       (n + 1.0)) - 1.0)
                        + self.c_sigma)
        self.c_c = (4.0 + me / n) / (n + 4.0 + 2.0 * me / n)
        c1 = 2.0 / ((n + 1.3) ** 2 + me)
        cmu = min(1.0 - c1,
                  2.0 * (me - 2.0 + 1.0 / me) / ((n + 2.0) ** 2 + me))
        if sep_scaling:
            sep = (n + 2.0) / 3.0
            self.c_1 = min(1.0, c1 * sep)
            self.c_mu = min(1.0 - self.c_1, cmu * sep)
        else:
            self.c_1 = c1
            self.c_mu = cmu
        self.chi_n = math.sqrt(n) * (1.0 - 1.0 / (4.0 * n)
                                     + 1.0 / (21.0 * n * n))

    def init_state(self, m0=None) -> Tuple:
        """``(m, sigma, C, p_sigma, p_c, gen)`` on the device; ``m0``
        defaults to zeros. ``sigma`` is a 0-d f32 tensor and ``gen`` a
        0-d int32 tensor, so that a captured generation counts."""
        m = (torch.zeros(self.dim, device=self.device) if m0 is None
             else torch.as_tensor(m0, dtype=torch.float32,
                                  device=self.device))
        if m.shape != (self.dim,):
            raise ValueError(f"m0 shape {tuple(m.shape)} != ({self.dim},)")
        z = torch.zeros(self.dim, device=self.device)
        return (m, torch.tensor(self.sigma_init, device=self.device),
                self._init_cov(), z, z.clone(),
                torch.zeros((), dtype=torch.int32, device=self.device))

    def _generation(self, m, sigma, C, p_sigma, p_c, gen, z, states, prep):
        mesh, n, ld = self.mesh, self.mesh.n_dev, self.lam_per_dev
        c_sigma, c_c, mu_eff = self.c_sigma, self.c_c, self.mu_eff
        y = self._sample(z, prep)                        # (lam, dim)
        fit = self.eval_fn(m + sigma * y, states)        # (lam,)
        # rank 0 = best (max fitness); ties keep their order
        order = torch.argsort(-fit, stable=True)
        ranks = torch.empty_like(order)
        ranks[order] = torch.arange(self.pop_size, device=fit.device)
        w = self.w_table[ranks]
        ws = [w[r * ld:(r + 1) * ld] for r in range(n)]
        ys = [y[r * ld:(r + 1) * ld] for r in range(n)]
        zs = [z[r * ld:(r + 1) * ld] for r in range(n)]
        yw = collectives.psum([a @ b for a, b in zip(ws, ys)], mesh)
        zw = collectives.psum([a @ b for a, b in zip(ws, zs)], mesh)
        moment = collectives.psum(
            [self._cov_moment(a, b) for a, b in zip(ws, ys)], mesh)

        p_sigma = ((1.0 - c_sigma) * p_sigma
                   + math.sqrt(c_sigma * (2.0 - c_sigma) * mu_eff)
                   * self._whiten(zw, prep))
        norm_ps = torch.linalg.norm(p_sigma)
        decay = 1.0 - (1.0 - c_sigma) ** (2.0 * (gen + 1.0))
        h_sigma = torch.where(
            norm_ps / torch.sqrt(decay)
            < (1.4 + 2.0 / (self.dim + 1.0)) * self.chi_n, 1.0, 0.0)
        p_c = ((1.0 - c_c) * p_c
               + h_sigma * math.sqrt(c_c * (2.0 - c_c) * mu_eff) * yw)
        new_m = m + sigma * yw
        new_C = self._cov_update(prep, moment, p_c, h_sigma)
        new_sigma = sigma * torch.exp(
            (c_sigma / self.d_sigma) * (norm_ps / self.chi_n - 1.0))
        stats = torch.stack([fit.mean(), fit.max(), new_sigma])
        return new_m, new_sigma, new_C, p_sigma, p_c, gen + 1, stats

    def _draw(self):
        """A generation's draws in order: z, states."""
        z = torch.randn(self.pop_size, self.dim, generator=self.generator,
                        device=self.device)
        return z, self.reset_fn(self.pop_size, self.generator)

    def _device_step_fn(self, m, sigma, C, p_sigma, p_c, gen, *prep):
        """One generation with its own draws: the fused runner's body.
        ``prep`` is ``_eager_prep``'s output where the class names one,
        else the factorisation runs here."""
        z, states = self._draw()
        return self._generation(m, sigma, C, p_sigma, p_c, gen, z, states,
                                prep or self._prep_cov(C))

    @torch.no_grad()
    def step(self, state, z=None, states=None):
        """One generation: ``(state, stats)`` with stats the f32 tensor
        [mean fitness, max fitness, new sigma]. ``z`` (pop, dim) and
        ``states`` (pop, ...) are drawn from the generator when not
        given; both are rank-major, rank r's rows ``r * lam_per_dev ..
        (r + 1) * lam_per_dev``."""
        if z is None or states is None:
            dz, dstates = self._draw()
            z = dz if z is None else z
            states = dstates if states is None else states
        if z.shape != (self.pop_size, self.dim):
            raise ValueError(f"z shape {tuple(z.shape)} != "
                             f"({self.pop_size}, {self.dim})")
        if states.shape[0] != self.pop_size:
            raise ValueError(f"{states.shape[0]} env states for a "
                             f"population of {self.pop_size}")
        *new, stats = self._generation(*state, z, states,
                                       self._prep_cov(state[2]))
        return tuple(new), stats

    def run(self, state, generations: int):
        """N generations; returns (state, stats history)."""
        return run_steps(self.step, state, generations)


class SepCMAES(_CMABase):
    """Diagonal CMA-ES. ``state = (m, sigma, C, p_sigma, p_c, gen)`` with
    ``C`` the (dim,) covariance diagonal."""

    def __init__(self, eval_fn: Callable, reset_fn: Callable, dim: int,
                 pop_size: int, sigma_init: float = 0.3, device=None,
                 generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None) -> None:
        super().__init__(eval_fn, reset_fn, dim, pop_size, sigma_init,
                         True, device, generator, mesh)

    def _init_cov(self):
        return torch.ones(self.dim, device=self.device)

    def _prep_cov(self, C):
        return (C,)

    def _sample(self, z, prep):
        return torch.sqrt(prep[0]) * z

    def _whiten(self, zw, prep):
        return zw                                        # C^-1/2 y = z

    def _cov_moment(self, w, y):
        return w @ (y * y)                               # (dim,)

    def _cov_update(self, prep, y2w, p_c, h_sigma):
        C = prep[0]
        new_C = ((1.0 - self.c_1 - self.c_mu) * C
                 + self.c_1 * (p_c * p_c + (1.0 - h_sigma) * self.c_c
                               * (2.0 - self.c_c) * C)
                 + self.c_mu * y2w)
        return torch.clamp_min(new_C, 1e-20)


class CMAES(_CMABase):
    """Full-covariance CMA-ES. ``state = (m, sigma, C (dim, dim),
    p_sigma, p_c, gen)``.

    Each generation factors the symmetrised C as ``B diag(D^2) B^T``
    with ``torch.linalg.eigh``, samples ``y = (z * D) @ B^T`` and
    whitens ``<y>_w`` as ``B <z>_w``. Eigenvectors are fixed only up to
    sign (and within repeated eigenvalues up to rotation), and LAPACK,
    cuSOLVER and XLA choose differently; y and ``C^{-1/2} <y>_w`` do not
    depend on the choice for the same distribution of z, but one
    trajectory does.

    ``run_fused`` on CUDA runs the eigh eagerly before every replay of
    the captured remainder (``_eager_prep``), because the CUDA eigh
    checks its result on the host, which a capture refuses: every
    generation then waits once for the card, and the rollouts and
    updates still replay from the graph.
    """

    def __init__(self, eval_fn: Callable, reset_fn: Callable, dim: int,
                 pop_size: int, sigma_init: float = 0.3, device=None,
                 generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None) -> None:
        super().__init__(eval_fn, reset_fn, dim, pop_size, sigma_init,
                         False, device, generator, mesh)

    def _init_cov(self):
        return torch.eye(self.dim, device=self.device)

    def _prep_cov(self, C):
        C_sym = 0.5 * (C + C.T)
        eigval, B = torch.linalg.eigh(C_sym)
        return C_sym, B, torch.sqrt(torch.clamp_min(eigval, 1e-20))

    def _eager_prep(self, m, sigma, C, p_sigma, p_c, gen):
        """The eigh, outside the captured generation."""
        return self._prep_cov(C)

    def _sample(self, z, prep):
        _, B, D = prep
        return (z * D) @ B.T

    def _whiten(self, zw, prep):
        return prep[1] @ zw                              # C^-1/2 <y>_w

    def _cov_moment(self, w, y):
        return y.T @ (w[:, None] * y)                    # (dim, dim)

    def _cov_update(self, prep, ywyT, p_c, h_sigma):
        C_sym = prep[0]
        return ((1.0 - self.c_1 - self.c_mu) * C_sym
                + self.c_1 * (torch.outer(p_c, p_c) + (1.0 - h_sigma)
                              * self.c_c * (2.0 - self.c_c) * C_sym)
                + self.c_mu * ywyT)
