"""Novelty-search evolution strategies (NS-ES, NSR-ES, NSRA-ES) with a
behavior archive on the device.

Counterpart of ``fiber_tpu/ops/novelty.py`` (``knn_novelty``,
``NoveltyState``, ``NoveltyES``, ``NoveltyPopulation``). ``eval_fn``
returns ``(fitness (m,), behaviors (m, bc_dim))``; a generation
evaluates every rank's antithetic members in one call over the
rank-major population, scores each behavior's novelty as its mean
distance to its k nearest neighbours in the archive (a ring buffer of
static shape), blends fitness ranks and novelty ranks with the weight
``w``, and ascends the blend. The updated policy's own behavior, from
its own start state ``center_state``, enters the ring at slot
``count % capacity``, written at a tensor index so that a captured
generation writes the next slot on every replay. ``count``, ``w``,
``best`` and ``stag`` are 0-d tensors for the same reason; the adaptive
weight (NSRA-ES) moves by ``torch.where``, with no branch on the host.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from fiber_tpu_torch.ops import collectives
from fiber_tpu_torch.ops.es import _FusedRunMixin, centered_rank, run_steps
from fiber_tpu_torch.parallel.mesh import Mesh, mesh_for


def knn_novelty(bcs, archive, count, k: int):
    """Mean distance of each row of ``bcs`` (B, D) to its k nearest live
    rows of ``archive`` (C, D); ``count`` (a 0-d tensor or a number) is
    how many ring slots were ever written, so ``min(count, C)`` are live.

    Squared distances take the expansion ``|a|^2 + |b|^2 - 2 a.b``. The
    cross term sums f32 products elementwise rather than through a
    matmul: a CUDA matmul may run in TF32 when the process allows it
    globally, and its ~1e-3 relative error is the size of the gaps
    between near neighbours (the JAX package asks for
    ``Precision.HIGHEST``). Behaviors are low-dimensional, so the
    (B, C, D) products are small. Dead slots are ``inf`` and never
    neighbours; with fewer than k live rows the mean is over the live
    ones.
    """
    b_sq = (bcs * bcs).sum(1, keepdim=True)                  # (B, 1)
    a_sq = (archive * archive).sum(1)[None, :]               # (1, C)
    cross = (bcs[:, None, :] * archive[None, :, :]).sum(-1)  # (B, C)
    d2 = torch.clamp_min(b_sq + a_sq - 2.0 * cross, 0.0)
    capacity = archive.shape[0]
    count = torch.as_tensor(count, device=bcs.device)
    live = torch.arange(capacity, device=bcs.device)[None, :] < count
    d2 = torch.where(live, d2, torch.inf)
    kk = min(k, capacity)
    best = torch.topk(d2, kk, dim=1, largest=False).values   # ascending
    n_valid = torch.clamp(count, 1, kk)
    valid = torch.arange(kk, device=bcs.device)[None, :] < n_valid
    dists = torch.sqrt(torch.where(valid, best, 0.0))
    return dists.sum(1) / n_valid.to(dists.dtype)


class NoveltyState(NamedTuple):
    """The search state on the device (checkpointable as it stands)."""

    params: torch.Tensor   # (dim,) policy parameters
    archive: torch.Tensor  # (capacity, bc_dim) behavior ring buffer
    count: torch.Tensor    # 0-d int32: admissions ever; the next slot is
    #                        count % capacity, min(count, capacity) live
    w: torch.Tensor        # 0-d f32: reward weight in [0, 1]
    best: torch.Tensor     # 0-d f32: best population max fitness seen
    stag: torch.Tensor     # 0-d int32: generations since a record


class NoveltyES(_FusedRunMixin):
    """The NS-ES family on the ES step's skeleton.

    ``eval_fn(thetas (m, dim), states (m, ...)) -> (fitness (m,),
    behaviors (m, bc_dim))`` and ``reset_fn(n, generator) -> states``.
    Modes:

    * ``reward_weight=0.0``: NS-ES, the pure novelty gradient;
    * ``reward_weight=0.5``: NSR-ES, an equal blend;
    * ``adaptive=True``: NSRA-ES, ``w`` starts at ``reward_weight``,
      rises by ``weight_delta`` on every record population max and falls
      by it after ``patience`` generations without one.
    """

    def __init__(
        self,
        eval_fn: Callable,
        reset_fn: Callable,
        dim: int,
        bc_dim: int,
        pop_size: int,
        sigma: float = 0.1,
        lr: float = 0.02,
        archive_size: int = 256,
        k: int = 10,
        reward_weight: float = 0.5,
        adaptive: bool = False,
        weight_delta: float = 0.05,
        patience: int = 10,
        device=None,
        generator: Optional[torch.Generator] = None,
        mesh: Optional[Mesh] = None,
    ) -> None:
        if not 0.0 <= reward_weight <= 1.0:
            raise ValueError(f"reward_weight {reward_weight} not in [0,1]")
        self.mesh = mesh_for(device, mesh)
        self.device = self.mesh.device
        self.eval_fn = eval_fn
        self.reset_fn = reset_fn
        self.dim = int(dim)
        self.bc_dim = int(bc_dim)
        self.sigma = float(sigma)
        self.lr = float(lr)
        self.archive_size = int(archive_size)
        self.k = int(k)
        self.reward_weight = float(reward_weight)
        self.adaptive = bool(adaptive)
        self.weight_delta = float(weight_delta)
        self.patience = int(patience)
        quantum = 2 * self.mesh.n_dev
        self.pop_size = max(quantum, (pop_size // quantum) * quantum)
        self.pairs = self.pop_size // 2
        self.pairs_per_dev = self.pop_size // quantum
        self.generator = generator or torch.Generator(
            device=self.device).manual_seed(0)

    def init_state(self, params0, state=None) -> NoveltyState:
        """The archive seeded with the starting policy's behavior from
        ``state`` (one env start state, (1, ...); drawn from the
        generator when not given), so that the first generation's
        novelty is defined."""
        params0 = torch.as_tensor(params0, dtype=torch.float32,
                                  device=self.device)
        if params0.shape != (self.dim,):
            raise ValueError(f"params0 shape {tuple(params0.shape)} != "
                             f"({self.dim},)")
        if state is None:
            state = self.reset_fn(1, self.generator)
        with torch.no_grad():
            _, bc0 = self.eval_fn(params0[None], state)
        archive = torch.zeros(self.archive_size, self.bc_dim,
                              device=self.device)
        archive[0] = bc0[0].float()
        return NoveltyState(
            params=params0, archive=archive,
            count=torch.ones((), dtype=torch.int32, device=self.device),
            w=torch.tensor(self.reward_weight, device=self.device),
            best=torch.tensor(-torch.inf, device=self.device),
            stag=torch.zeros((), dtype=torch.int32, device=self.device))

    def _generation(self, params, archive, count, w, best, stag, eps,
                    states, center_state):
        mesh, n, k = self.mesh, self.mesh.n_dev, self.pairs_per_dev
        e = eps.reshape(n, k, self.dim)
        thetas = torch.cat([params + self.sigma * e,
                            params - self.sigma * e], dim=1)
        fit, bcs = self.eval_fn(thetas.reshape(self.pop_size, self.dim),
                                states)
        novelty = knn_novelty(bcs.float(), archive, count, self.k)
        rank_f = centered_rank(fit)
        rank_n = centered_rank(novelty)
        blend = (w * rank_f + (1.0 - w) * rank_n).reshape(n, 2 * k)
        grad = collectives.psum(
            [(blend[r, :k] - blend[r, k:]) @ e[r] for r in range(n)],
            mesh) / (self.pop_size * self.sigma)
        new_params = params + self.lr * grad

        # admission: the updated policy's behavior, at slot count % C
        _, bc_c = self.eval_fn(new_params[None], center_state)
        idx = torch.remainder(count, self.archive_size).reshape(1).long()
        new_archive = archive.index_copy(0, idx, bc_c.float())
        new_count = count + 1

        gen_best = fit.max()
        if self.adaptive:
            improved = gen_best > best
            w_up = torch.clamp_max(w + self.weight_delta, 1.0)
            stag_next = torch.where(improved, 0, stag + 1)
            stalled = stag_next >= self.patience
            w_next = torch.where(
                improved, w_up,
                torch.where(stalled,
                            torch.clamp_min(w - self.weight_delta, 0.0), w))
            stag_next = torch.where(stalled, 0, stag_next)
        else:
            w_next, stag_next = w, stag
        best_next = torch.maximum(best, gen_best)
        stats = torch.stack([fit.mean(), gen_best, novelty.mean(), w])
        return (new_params, new_archive, new_count, w_next, best_next,
                stag_next, stats)

    def _draw(self):
        """A generation's draws in order: eps, states, center_state."""
        eps = torch.randn(self.pairs, self.dim, generator=self.generator,
                          device=self.device)
        states = self.reset_fn(self.pop_size, self.generator)
        return eps, states, self.reset_fn(1, self.generator)

    def _device_step_fn(self, *state):
        """One generation with its own draws: the fused runner's body."""
        return self._generation(*state, *self._draw())

    @torch.no_grad()
    def step(self, state: NoveltyState, eps=None, states=None,
             center_state=None) -> Tuple[NoveltyState, torch.Tensor]:
        """One generation: ``(state, stats)`` with stats the f32 tensor
        [mean fitness, max fitness, mean novelty, reward weight]. The
        draws ``eps`` (pairs, dim), the population's ``states`` (pop,
        ...) and the centre's ``center_state`` (1, ...) come from the
        generator when not given; ``eps`` and ``states`` are rank-major
        as in ``EvolutionStrategy.step``."""
        if eps is None or states is None or center_state is None:
            d_eps, d_states, d_center = self._draw()
            eps = d_eps if eps is None else eps
            states = d_states if states is None else states
            center_state = d_center if center_state is None else center_state
        if eps.shape != (self.pairs, self.dim):
            raise ValueError(f"eps shape {tuple(eps.shape)} != "
                             f"({self.pairs}, {self.dim})")
        if states.shape[0] != self.pop_size:
            raise ValueError(f"{states.shape[0]} env states for a "
                             f"population of {self.pop_size}")
        *new, stats = self._generation(*state, eps, states, center_state)
        return NoveltyState(*new), stats

    def run(self, state: NoveltyState, generations: int):
        """N generations; returns (state, stats history)."""
        return run_steps(self.step, state, generations)


class NoveltyPopulation:
    """Meta-population NS-ES: m agents share one behavior archive. Each
    step picks an agent with probability proportional to the novelty of
    its current behavior against the shared archive (uniformly when
    every novelty is 0) and advances it one :class:`NoveltyES`
    generation; the grown archive is then every agent's. The pick is
    made on the host (m is small); each generation stays one
    ``NoveltyES.step``."""

    def __init__(self, nes: NoveltyES, m: int) -> None:
        if m < 1:
            raise ValueError(f"need m >= 1 agents, got {m}")
        self.nes = nes
        self.m = int(m)
        self._states: List[NoveltyState] = []
        self.last_probs = None

    def init(self, params0_list, states=None) -> None:
        """One starting parameter vector per agent; ``states`` (m, ...)
        holds each agent's start state for its seed behavior (drawn when
        not given). Every seed behavior enters the shared archive, in
        agent order."""
        if len(params0_list) != self.m:
            raise ValueError(f"need {self.m} parameter vectors, got "
                             f"{len(params0_list)}")
        nes = self.nes
        if states is None:
            states = nes.reset_fn(self.m, nes.generator)
        self._states = [nes.init_state(p, states[i:i + 1])
                        for i, p in enumerate(params0_list)]
        archive = self._states[0].archive.clone()
        count = self._states[0].count
        for st in self._states[1:]:
            archive[int(count) % nes.archive_size] = st.archive[0]
            count = count + 1
        self._states = [st._replace(archive=archive, count=count)
                        for st in self._states]

    def agent_params(self):
        """The agents' current parameter vectors."""
        return [st.params for st in self._states]

    @torch.no_grad()
    def step(self, pick: Optional[int] = None, eval_states=None, **draws):
        """Picks an agent and advances it one generation. Returns
        (picked index, stats). ``eval_states`` (m, ...) start the
        agents' current-behavior rollouts; ``pick`` overrides the draw
        (the probabilities are still computed, in ``last_probs``); the
        generation's own draws pass through to :meth:`NoveltyES.step`
        (``eps``, ``states``, ``center_state``)."""
        nes = self.nes
        shared = self._states[0]
        if eval_states is None:
            eval_states = nes.reset_fn(self.m, nes.generator)
        _, bcs = nes.eval_fn(torch.stack(self.agent_params()), eval_states)
        nov = knn_novelty(bcs.float(), shared.archive, shared.count, nes.k)
        total = nov.sum()
        probs = torch.where(total > 0.0, nov / torch.clamp_min(total, 1e-9),
                            torch.full_like(nov, 1.0 / self.m))
        self.last_probs = probs
        if pick is None:
            pick = int(torch.multinomial(probs, 1, generator=nes.generator))
        st = self._states[pick]._replace(archive=shared.archive,
                                         count=shared.count)
        new_st, stats = nes.step(st, **draws)
        self._states[pick] = new_st
        self._states = [s._replace(archive=new_st.archive,
                                   count=new_st.count)
                        for s in self._states]
        return pick, stats
