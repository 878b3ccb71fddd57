"""OpenAI-ES over a mesh of ranks: antithetic perturbation, population
rollout, centered-rank shaping, gradient estimate and update, one
generation at a time or N generations as one CUDA-graph replay.

Counterpart of ``fiber_tpu/ops/es.py`` (``run_steps``,
``build_fused_runner``, ``_FusedRunMixin``, ``apply_es_update``,
``centered_rank``, ``EvolutionStrategy.step``, ``run``, ``run_fused``
and ``reset_optimizer``, and ``AskTellES``). The JAX step is one SPMD
program over the mesh. On the port's single-controller mesh
(``parallel/mesh.py``), whose ranks all sit on one device, the step
evaluates every rank's antithetic half-population in one ``eval_fn``
call over the rank-major concatenation, splits the fitness back to
(ranks, members), ranks it over the whole population and sums the
per-rank gradients (``ops/collectives``). Where JAX scans N generations
inside one XLA program, the port captures one generation in a CUDA graph
and replays it N times. :class:`AskTellES` is the same update behind an
ask/tell interface, for evaluators that live on the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from fiber_tpu_torch.device import resolve_device
from fiber_tpu_torch.ops import collectives
from fiber_tpu_torch.parallel.mesh import Mesh, mesh_for


def run_steps(step, state, generations: int):
    """Shared generation loop: N ``step(state) -> (state, stats)``
    calls, returning (state, stats history). :meth:`EvolutionStrategy.run`
    and the state-tuple families (PGPE, CMA-ES, NoveltyES, MAP-Elites)
    drive their steps with it. The JAX loop splits a key per
    generation; here each family's step draws from its own
    ``torch.Generator``, which advances itself."""
    history = []
    for _ in range(generations):
        state, stats = step(state)
        history.append(stats)
    return state, history


class _GraphRunner:
    """One generation captured in a CUDA graph over static state
    buffers, replayed N times (see :func:`build_fused_runner`)."""

    def __init__(self, device_step, device, n_state, generations,
                 generator, eager_prep=None):
        self.device_step = device_step
        self.device = device
        self.n_state = n_state
        self.generations = generations
        self.generator = generator
        self.eager_prep = eager_prep
        self.graph = None
        self.static = None          # the state slots the graph reads
        self.static_prep = []       # eager_prep's outputs, read too
        self.static_stats = None    # the stats the graph writes

    def _run_prep(self):
        """Refreshes the prep slots from the state slots, outside the
        graph."""
        if self.eager_prep is not None:
            for slot, x in zip(self.static_prep,
                               self.eager_prep(*self.static)):
                slot.copy_(x)

    def _capture(self, state):
        """Warm-up on a side stream, then capture one generation whose
        last act is to copy the new state into the static slots. The
        generator's state is restored after both, so that the first
        replay draws what the first eager step would."""
        self.static = [x.detach().clone() for x in state]
        if self.eager_prep is not None:
            self.static_prep = [x.detach().clone()
                                for x in self.eager_prep(*self.static)]
        g = self.generator
        saved = None if g is None else g.get_state()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.device_step(*[x.clone() for x in self.static],
                             *self.static_prep)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if g is not None:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph):
            *new, stats = self.device_step(*self.static, *self.static_prep)
            for slot, x in zip(self.static, new):
                if x is not slot:
                    slot.copy_(x)
        if g is not None:
            g.set_state(saved)
        self.graph, self.static_stats = graph, stats

    def __call__(self, *state):
        if len(state) != self.n_state:
            raise ValueError(f"{len(state)} state slots, the runner was "
                             f"built for {self.n_state}")
        with torch.no_grad(), torch.cuda.device(self.device):
            if self.graph is None:
                self._capture(state)
            for slot, x in zip(self.static, state):
                if x.shape != slot.shape or x.dtype != slot.dtype:
                    raise ValueError(
                        f"state slot {tuple(x.shape)} {x.dtype} differs "
                        f"from the captured {tuple(slot.shape)} "
                        f"{slot.dtype}")
                slot.copy_(x)
            stats_seq = torch.empty(
                (self.generations, *self.static_stats.shape),
                dtype=self.static_stats.dtype, device=self.device)
            for i in range(self.generations):
                self._run_prep()
                self.graph.replay()
                stats_seq[i].copy_(self.static_stats)
            return (*[slot.clone() for slot in self.static], stats_seq)


def build_fused_runner(device_step, mesh: Mesh, n_state: int,
                       generations: int,
                       generator: Optional[torch.Generator] = None,
                       eager_prep: Optional[Callable] = None):
    """N generations in one go, shared by every algorithm family.

    ``device_step(*state) -> (*state, stats)`` is one generation over
    ``n_state`` tensor slots, drawing its randomness from
    ``generator``. The returned runner maps ``(*state) -> (*state,
    stats_seq)`` with ``stats_seq.shape[0] == generations``: the same
    trajectory as N ``device_step`` calls.

    On CUDA the runner's first call captures one generation into a
    ``torch.cuda.CUDAGraph`` over static copies of the state, with
    ``generator`` registered to the graph, and every call replays it N
    times, copying each replay's stats into its row of the result (a
    device-to-device copy, no host sync). There is no fallback: a
    capture that fails raises. On the CPU the runner loops
    ``device_step``.

    ``eager_prep(*state) -> tuple of tensors``, when given, is work that
    a capture refuses (CMAES's ``eigh``, which checks its result on the
    host): it runs outside the graph before every generation, and its
    outputs enter ``device_step(*state, *prep)`` as further inputs,
    which the graph reads from static slots.
    """
    if generations < 1:
        raise ValueError(f"generations must be >= 1, got {generations}")
    if mesh.device.type == "cuda":
        return _GraphRunner(device_step, mesh.device, n_state, generations,
                            generator, eager_prep)

    def run_loop(*state):
        if len(state) != n_state:
            raise ValueError(f"{len(state)} state slots, the runner was "
                             f"built for {n_state}")
        history = []
        with torch.no_grad():
            for _ in range(generations):
                prep = () if eager_prep is None else eager_prep(*state)
                *state, stats = device_step(*state, *prep)
                history.append(stats)
        return (*state, torch.stack(history))

    return run_loop


class _FusedRunMixin:
    """run_fused() for the state-tuple families. Requires
    ``self._device_step_fn`` (one generation over the state slots),
    ``self.mesh`` and ``self.generator``, and the ``step``/``run``
    contract ``state = tuple``; a family whose generation holds work
    that a CUDA graph cannot capture names it as ``_eager_prep`` (see
    :func:`build_fused_runner`). Runners are cached per
    instance and generation count, as the JAX package caches its
    compiled runners: shapes and optimizer are fixed once captured.
    A NamedTuple state comes back as its own type."""

    _eager_prep = None

    def run_fused(self, state, generations: int):
        """Run N generations as one replay. Returns (state, stats_seq
        (generations, k)): the same trajectory as N ``step`` calls."""
        cache = self.__dict__.setdefault("_fused_runner_cache", {})
        fn = cache.get(generations)
        if fn is None:
            fn = build_fused_runner(self._device_step_fn, self.mesh,
                                    len(tuple(state)), generations,
                                    generator=self.generator,
                                    eager_prep=self._eager_prep)
            cache[generations] = fn
        out = fn(*tuple(state))
        new_state = tuple(out[:-1])
        if hasattr(type(state), "_make"):
            new_state = type(state)._make(new_state)
        return new_state, out[-1]


def apply_es_update(params, grad, m, v, t, *, lr, wd, adam,
                    b1=0.9, b2=0.999, eps=1e-8):
    """Ascent step: SGD or bias-corrected Adam on the estimated gradient,
    with decoupled weight decay. ``t`` is the step count, a 0-d tensor
    on the params' device (a number works too), advanced by tensor
    arithmetic so that a captured step counts on every replay. Returns
    ``(new_params, m, v, t)``; in SGD mode the moment slots pass through
    untouched."""
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


class EvolutionStrategy(_FusedRunMixin):
    """OpenAI-ES with antithetic sampling and rank shaping.

    ``eval_fn(thetas (m, dim), env_states (m, ...)) -> (m,)`` fitness
    evaluates a population at once;
    ``reset_fn(n, generator) -> env_states`` draws initial states. Noise
    and states come from ``generator`` (a ``torch.Generator`` on the
    device; seed 0 when omitted) unless a step is handed them.

    ``mesh`` (n ranks; one rank on ``device`` when omitted) splits the
    population: rank r holds ``pop / (2n)`` antithetic pairs, evaluated
    as ``[params + sigma * eps_r, params - sigma * eps_r]``, and a step
    evaluates all ranks' members in one ``eval_fn`` call, rank-major.
    After a step, ``last_fitness`` is the gathered (n, pop / n) fitness
    and ``last_grad`` the gradient estimate; after :meth:`run_fused` on
    CUDA both are the graph's static buffers, which every replay
    overwrites (clone them to keep a generation's values).
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
        self.mesh = mesh_for(device, mesh)
        self.device = self.mesh.device
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
        """(m, v, t): Adam's moments and its 0-d f32 step count on the
        params' device; in SGD mode zero-size placeholders, so that the
        fused runner's state slots are tensors in both modes."""
        if self.optimizer != "adam":
            empty = params.new_zeros(0)
            return empty, empty, params.new_zeros(())
        if params.shape != (self.dim,):
            raise ValueError(f"params shape {tuple(params.shape)} != "
                             f"({self.dim},)")
        if self._opt_state is None:
            zeros = torch.zeros_like(params)
            self._opt_state = (zeros, zeros, params.new_zeros(()))
        return self._opt_state

    def reset_optimizer(self) -> None:
        """Drops the Adam state (m, v, t), so that the next step starts it
        anew: one instance tracks one population's state, so call this
        when switching populations."""
        self._opt_state = None

    def _noise(self):
        """A generation's noise (pairs, dim), from the generator."""
        return torch.randn(self.pairs, self.dim, generator=self.generator,
                           device=self.device)

    def _generation(self, params, m, v, t, eps, states):
        """The per-device body: (new_params, m, v, t, stats)."""
        mesh, n, k = self.mesh, self.mesh.n_dev, self.pairs_per_dev
        # every rank sits on mesh.device: one eval_fn call over all
        # ranks' members, rank-major (rank r: its k "+" members, then
        # its k "-" members), split back to (n, 2k)
        e = eps.reshape(n, k, self.dim)
        thetas = torch.cat([params + self.sigma * e,
                            params - self.sigma * e], dim=1)
        all_fit = self.eval_fn(thetas.reshape(self.pop_size, self.dim),
                               states).reshape(n, 2 * k)
        # rank shaping over the whole population, gathered rank-major
        flat = all_fit.reshape(-1)
        ranks = centered_rank(flat).reshape(all_fit.shape)
        g_r = [(ranks[r, :k] - ranks[r, k:]) @ e[r] for r in range(n)]
        grad = collectives.psum(g_r, mesh) / (self.pop_size * self.sigma)
        new_params, m, v, t = apply_es_update(
            params, grad, m, v, t, lr=self.lr, wd=self.weight_decay,
            adam=self.optimizer == "adam")
        stats = torch.stack([flat.mean(), flat.max(), collectives.pmean(
            [f.mean() for f in all_fit], mesh)])
        self.last_fitness, self.last_grad = all_fit, grad
        return new_params, m, v, t, stats

    def _device_step_fn(self, params, m, v, t):
        """One generation over the state slots, drawing its noise and
        initial states as :meth:`step` does: the fused runner's body."""
        eps = self._noise()
        states = self.reset_fn(self.pop_size, self.generator)
        return self._generation(params, m, v, t, eps, states)

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
            eps = self._noise()
        if states is None:
            states = self.reset_fn(self.pop_size, self.generator)
        if eps.shape != (self.pairs, self.dim):
            raise ValueError(f"eps shape {tuple(eps.shape)} != "
                             f"({self.pairs}, {self.dim})")
        if states.shape[0] != self.pop_size:
            raise ValueError(f"{states.shape[0]} env states for a "
                             f"population of {self.pop_size}")
        m, v, t = self._ensure_opt_state(params)
        new_params, m, v, t, stats = self._generation(params, m, v, t, eps,
                                                      states)
        if self.optimizer == "adam":
            self._opt_state = (m, v, t)
        return new_params, stats

    def run(self, params, generations: int, log_every: int = 0):
        """N generations; returns (params, history of (gen, mean, max))
        logged every ``log_every`` generations and at the last."""
        params, stats = run_steps(self.step, params, generations)
        history = [(gen, *s[:2].tolist()) for gen, s in enumerate(stats)
                   if log_every and (gen % log_every == 0
                                     or gen == generations - 1)]
        return params, history

    def run_fused(self, params, generations: int):
        """Run N generations as one replay (on CUDA, one captured
        generation replayed N times; on the CPU, N steps). Returns
        (params, stats (generations, 3)); optimizer state advances
        exactly as with :meth:`run`."""
        m, v, t = self._ensure_opt_state(params)
        (params, m, v, t), stats = _FusedRunMixin.run_fused(
            self, (params, m, v, t), generations)
        if self.optimizer == "adam":
            self._opt_state = (m, v, t)
        return params, stats


class AskTellES:
    """OpenAI-ES behind an ask/tell interface, for evaluators that are
    not tensor programs (external simulators, subprocess rollouts, gym
    envs farmed out through a pool)::

        es = AskTellES(dim, pop_size, device="cuda")
        thetas = es.ask()                     # (pop, dim) numpy
        fits = pool.map(simulate, thetas)     # any Python
        es.tell(fits)                         # rank-shape + update

    Sampling and the update run on ``device`` with the math of
    :class:`EvolutionStrategy` (antithetic pairs, centered-rank shaping,
    :func:`apply_es_update` with a 0-d step count); only the candidate
    matrix and the fitnesses cross to and from the host. Noise comes
    from ``generator`` (seed 0 when omitted) unless :meth:`ask` is
    handed it.
    """

    def __init__(
        self,
        dim: int,
        pop_size: int,
        sigma: float = 0.1,
        lr: float = 0.02,
        weight_decay: float = 0.0,
        optimizer: str = "sgd",
        params0=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        if optimizer not in ("sgd", "adam"):
            raise ValueError(f"unknown optimizer {optimizer!r}")
        if pop_size < 2:
            raise ValueError("pop_size must be >= 2")
        self.device = resolve_device(device)
        self.dim = int(dim)
        self.pairs = max(1, pop_size // 2)
        self.pop_size = 2 * self.pairs
        self.sigma = float(sigma)
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.optimizer = optimizer
        self.params = (
            torch.zeros(self.dim, device=self.device) if params0 is None
            else torch.as_tensor(params0, dtype=torch.float32,
                                 device=self.device))
        if self.params.shape != (self.dim,):
            raise ValueError(f"params0 shape {tuple(self.params.shape)} "
                             f"!= ({dim},)")
        # SGD carries zero-size moment placeholders, as EvolutionStrategy
        zeros = (torch.zeros_like(self.params) if optimizer == "adam"
                 else self.params.new_zeros(0))
        self._m, self._v, self._t = zeros, zeros, self.params.new_zeros(())
        self.generator = generator or torch.Generator(
            device=self.device).manual_seed(0)
        self._eps = None  # set by ask(), consumed by tell()

    def ask(self, eps=None):
        """The next antithetic population: a (pop_size, dim) f32 numpy
        array, rows ``[params + sigma * eps; params - sigma * eps]``.
        ``eps`` (pairs, dim) is drawn from the generator when not
        given."""
        if self._eps is not None:
            raise RuntimeError("ask() called twice without tell()")
        if eps is None:
            eps = torch.randn(self.pairs, self.dim, generator=self.generator,
                              device=self.device)
        eps = torch.as_tensor(eps, dtype=torch.float32, device=self.device)
        if eps.shape != (self.pairs, self.dim):
            raise ValueError(f"eps shape {tuple(eps.shape)} != "
                             f"({self.pairs}, {self.dim})")
        thetas = torch.cat([self.params + self.sigma * eps,
                            self.params - self.sigma * eps])
        self._eps = eps
        return thetas.cpu().numpy()

    @torch.no_grad()
    def tell(self, fitnesses) -> dict:
        """Reports the fitnesses (pop_size of them, in :meth:`ask`'s row
        order; higher is better) and applies the update. Returns the
        mean and max fitness."""
        if self._eps is None:
            raise RuntimeError("tell() called before ask()")
        fits = torch.as_tensor(np.asarray(fitnesses, np.float32)).reshape(
            -1).to(self.device)
        if fits.shape[0] != self.pop_size:
            raise ValueError(
                f"need {self.pop_size} fitnesses, got {fits.shape[0]}")
        ranks = centered_rank(fits)
        w = ranks[:self.pairs] - ranks[self.pairs:]
        grad = (w @ self._eps) / (self.pop_size * self.sigma)
        self.params, self._m, self._v, self._t = apply_es_update(
            self.params, grad, self._m, self._v, self._t, lr=self.lr,
            wd=self.weight_decay, adam=self.optimizer == "adam")
        self._eps = None
        return {"mean_fitness": float(fits.mean()),
                "max_fitness": float(fits.max())}
