"""MAP-Elites (quality-diversity) with a grid archive on the device.

Counterpart of ``fiber_tpu/ops/map_elites.py`` (``MapElitesState``,
``MAPElites``). The archive is ``(cells, dim)`` genomes, ``(cells,)``
fitness (``-inf`` marks an empty cell) and ``(cells, bc_dim)``
behaviors. A generation draws parent cells uniformly over the filled
ones, perturbs their genomes, evaluates every child in one ``eval_fn``
call over the rank-major batch, and inserts: the candidates (children,
then the incumbents) go through a segment max per cell, first of the
fitness, then of the index of the highest candidate that reaches it,
and the winner's payload is gathered per cell. A scatter of the
payloads themselves would leave the order of duplicate writes
unspecified. A NaN fitness (a divergent rollout) is demoted to ``-inf``
first, so that it loses instead of poisoning the cell.

``eval_fn(thetas (m, dim), states (m, ...)) -> (fitness (m,), behaviors
(m, bc_dim))``, as for :class:`~fiber_tpu_torch.ops.novelty.NoveltyES`.
Behaviors are binned by ``bc_low``, ``bc_high`` and ``cells_per_dim``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fiber_tpu_torch.ops.es import run_steps
from fiber_tpu_torch.parallel.mesh import Mesh, mesh_for


class MapElitesState(NamedTuple):
    """The archive on the device (checkpointable as it stands)."""

    genomes: torch.Tensor    # (cells, dim)
    fitness: torch.Tensor    # (cells,); -inf marks an empty cell
    behaviors: torch.Tensor  # (cells, bc_dim): each elite's behavior


class MAPElites:
    """Grid-archive quality-diversity search over the mesh.

    ``cells_per_dim`` is an int (the same for every behavior dim) or a
    tuple; the cell count is their product. ``batch_size`` children a
    generation, rounded to the number of ranks. Draws come from
    ``generator`` (seed 0 when omitted) unless a step is handed them.
    """

    def __init__(
        self,
        eval_fn: Callable,
        reset_fn: Callable,
        dim: int,
        bc_dim: int,
        bc_low,
        bc_high,
        cells_per_dim=16,
        batch_size: int = 256,
        sigma: float = 0.1,
        device=None,
        generator: Optional[torch.Generator] = None,
        mesh: Optional[Mesh] = None,
    ) -> None:
        self.mesh = mesh_for(device, mesh)
        self.device = self.mesh.device
        self.eval_fn = eval_fn
        self.reset_fn = reset_fn
        self.dim = int(dim)
        self.bc_dim = int(bc_dim)
        self.bc_low = np.asarray(bc_low, np.float32).reshape(bc_dim)
        self.bc_high = np.asarray(bc_high, np.float32).reshape(bc_dim)
        if np.any(self.bc_high <= self.bc_low):
            raise ValueError("bc_high must exceed bc_low per dim")
        if isinstance(cells_per_dim, int):
            cells_per_dim = (cells_per_dim,) * bc_dim
        if len(cells_per_dim) != bc_dim:
            raise ValueError(
                f"cells_per_dim {cells_per_dim} != bc_dim {bc_dim}")
        self.cells_per_dim = tuple(int(c) for c in cells_per_dim)
        self.n_cells = int(np.prod(self.cells_per_dim))
        self.sigma = float(sigma)
        n_dev = self.mesh.n_dev
        self.batch_size = max(n_dev, (batch_size // n_dev) * n_dev)
        self.per_dev = self.batch_size // n_dev
        self.generator = generator or torch.Generator(
            device=self.device).manual_seed(0)
        dev = self.device
        self._low = torch.as_tensor(self.bc_low, device=dev)
        self._span = torch.as_tensor(self.bc_high - self.bc_low, device=dev)
        self._cpd = torch.as_tensor(self.cells_per_dim, dtype=torch.int32,
                                    device=dev)

    def init_state(self, params0, state=None) -> MapElitesState:
        """The archive seeded with the starting genome in its own cell,
        evaluated from ``state`` (one env start state, (1, ...); drawn
        from the generator when not given)."""
        params0 = torch.as_tensor(params0, dtype=torch.float32,
                                  device=self.device)
        if params0.shape != (self.dim,):
            raise ValueError(f"params0 shape {tuple(params0.shape)} != "
                             f"({self.dim},)")
        if state is None:
            state = self.reset_fn(1, self.generator)
        with torch.no_grad():
            fit0, bc0 = self.eval_fn(params0[None], state)
        cell = self._cell_of(bc0)
        genomes = torch.zeros(self.n_cells, self.dim, device=self.device)
        fitness = torch.full((self.n_cells,), -torch.inf,
                             device=self.device)
        behaviors = torch.zeros(self.n_cells, self.bc_dim,
                                device=self.device)
        genomes[cell] = params0
        fitness[cell] = fit0.float()
        behaviors[cell] = bc0.float()
        return MapElitesState(genomes, fitness, behaviors)

    def _cell_of(self, bcs):
        """Flat cell index (m,) int64 of each behavior row (m, bc_dim),
        row-major over the grid: each coordinate's bin truncated toward
        zero, then clamped to the grid."""
        frac = (bcs - self._low) / self._span
        idx = torch.clamp((frac * self._cpd).to(torch.int32), 0) \
            .minimum(self._cpd - 1).long()
        flat = torch.zeros(bcs.shape[0], dtype=torch.long,
                           device=bcs.device)
        for d in range(self.bc_dim):
            flat = flat * self.cells_per_dim[d] + idx[:, d]
        return flat

    def _generation(self, genomes, fitness, behaviors, parent_cells, noise,
                    states):
        children = genomes[parent_cells] + self.sigma * noise
        child_fit, child_bc = self.eval_fn(children, states)
        child_cells = self._cell_of(child_bc)

        n_cells = self.n_cells
        cand_fit = torch.cat([child_fit.float(), fitness])
        cand_fit = torch.where(torch.isnan(cand_fit), -torch.inf, cand_fit)
        cand_cells = torch.cat([child_cells,
                                torch.arange(n_cells, device=self.device)])
        cand_genomes = torch.cat([children.float(), genomes])
        cand_bc = torch.cat([child_bc.float(), behaviors])
        # every cell has its incumbent among the candidates
        seg_best = torch.full((n_cells,), -torch.inf,
                              device=self.device).scatter_reduce(
            0, cand_cells, cand_fit, "amax", include_self=False)
        n_cand = cand_fit.shape[0]
        is_winner = cand_fit == seg_best[cand_cells]
        winner = torch.full((n_cells,), -1, dtype=torch.long,
                            device=self.device).scatter_reduce(
            0, cand_cells,
            torch.where(is_winner, torch.arange(n_cand, device=self.device),
                        -1), "amax", include_self=False)
        new_genomes = cand_genomes[winner]
        new_behaviors = cand_bc[winner]

        filled = seg_best > -torch.inf
        stats = torch.stack([
            torch.where(filled, seg_best, 0.0).sum(), filled.float().mean(),
            seg_best.max(), torch.nanmean(child_fit.float())])
        return new_genomes, seg_best, new_behaviors, stats

    def _draw_parents(self, fitness):
        """``batch_size`` parent cells, uniform over the filled ones."""
        p = (fitness > -torch.inf).float()
        return torch.multinomial(p, self.batch_size, replacement=True,
                                 generator=self.generator)

    @torch.no_grad()
    def step(self, state: MapElitesState, parent_cells=None, noise=None,
             states=None) -> Tuple[MapElitesState, torch.Tensor]:
        """One generation: ``(state, stats)`` with stats the f32 tensor
        [qd score (sum of elite fitness), coverage, best fitness, mean
        child fitness over the non-NaN ones]. ``parent_cells``
        (batch,), ``noise`` (batch, dim) and ``states`` (batch, ...) are
        drawn from the generator in that order when not given; all three
        are rank-major, rank r's children rows ``r * per_dev .. (r + 1)
        * per_dev``."""
        if parent_cells is None:
            parent_cells = self._draw_parents(state.fitness)
        if noise is None:
            noise = torch.randn(self.batch_size, self.dim,
                                generator=self.generator, device=self.device)
        if states is None:
            states = self.reset_fn(self.batch_size, self.generator)
        parent_cells = torch.as_tensor(parent_cells, device=self.device).long()
        if parent_cells.shape != (self.batch_size,):
            raise ValueError(f"parent_cells shape {tuple(parent_cells.shape)}"
                             f" != ({self.batch_size},)")
        if noise.shape != (self.batch_size, self.dim):
            raise ValueError(f"noise shape {tuple(noise.shape)} != "
                             f"({self.batch_size}, {self.dim})")
        *new, stats = self._generation(*state, parent_cells, noise, states)
        return MapElitesState(*new), stats

    def run(self, state: MapElitesState, generations: int):
        """N generations; returns (state, stats history)."""
        return run_steps(self.step, state, generations)

    def elites(self, state: MapElitesState):
        """Host view: ``(cell, fitness, behavior, genome)`` of every
        filled cell, best first."""
        fit = state.fitness.cpu().numpy()
        genomes = state.genomes.cpu().numpy()
        bcs = state.behaviors.cpu().numpy()
        return [(int(c), float(fit[c]), bcs[c], genomes[c])
                for c in np.argsort(-fit) if np.isfinite(fit[c])]
