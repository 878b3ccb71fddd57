"""POET, the Paired Open-Ended Trailblazer, on the device.

Counterpart of ``fiber_tpu/ops/poet.py``: the published POET loop
(optimise each active (environment, agent) pair with ES; mutate the
environments, keep the children that pass the minimal criterion, rank
them by novelty against the archive and admit the most novel, retiring
the oldest pair at capacity; transfer agents between environments),
with the same records in ``history``.

* Every pair's ES step is one :class:`EvolutionStrategy` generation over
  the agent's parameters with the environment's vector riding in the
  tail, so that the members are evaluated under (perturbed) copies of
  that environment, and the tail pinned back after the update. One
  runner (``build_fused_runner``, one generation) serves every pair and
  the proposal stage, since the state's shape never changes: on CUDA it
  is one captured CUDA graph, replayed for each ES step of each pair,
  and the pair's environment enters it through the state slot, never
  through a closure.
* The transfer matrix is one batched ``rollout_p`` over the
  (n_env x n_agent) pairs, one initial state per agent shared across
  the environments.
* Mutation, the minimal criterion, novelty and admission run on the
  host, with JAX's semantics: numpy's first argmax, novelty ties broken
  toward the larger index, the margin ``0.05 * max(1, |incumbent|)``.

Draws on the device come from ``generator``; the parent pick, a host
integer, from ``pick_generator`` on the CPU. Every draw goes through a
small method (:meth:`_pick_parent`, :meth:`_mutation_noise`,
:meth:`_reset`; the ES's ``_noise`` and ``reset_fn``), so that a test
can hand the port the draws that it derives from JAX's keys.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from fiber_tpu_torch.ops.es import EvolutionStrategy, build_fused_runner
from fiber_tpu_torch.parallel.mesh import Mesh, mesh_for


def _host(env_params) -> np.ndarray:
    """An environment vector as a float64 numpy array."""
    if isinstance(env_params, torch.Tensor):
        env_params = env_params.detach().cpu().numpy()
    return np.asarray(env_params, dtype=float)


class POET:
    """POET over an env class with the ``ParamCartPole`` interface
    (``DEFAULT``, ``reset(n, generator)``, ``rollout_p(act_fn,
    env_params, thetas, states, max_steps=)``, ``mutate(env_params,
    noise=)``) and a policy with ``init``/``act``/``dim``. The active
    pairs are ``envs`` and ``agents`` (lists of tensors on ``device``),
    ``archive`` every environment ever admitted (float64 numpy).

    ``mesh`` (one rank on ``device`` when omitted) spreads every ES
    generation over its ranks, as the JAX package's POET hands its mesh
    to its shared ES; the population must then divide by twice the
    ranks. The transfer matrix and the single-pair evaluations run on
    ``mesh.device``."""

    def __init__(
        self,
        env_cls,
        policy,
        pop_size: int = 256,
        sigma: float = 0.1,
        lr: float = 0.03,
        max_pairs: int = 8,
        rollout_steps: int = 200,
        mc_low: float = 10.0,
        mc_high: Optional[float] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
        pick_generator: Optional[torch.Generator] = None,
        mesh: Optional[Mesh] = None,
    ) -> None:
        self.mesh = mesh_for(device, mesh)
        self.device = self.mesh.device
        self.env_cls = env_cls
        self.policy = policy
        self.max_pairs = max_pairs
        self.rollout_steps = rollout_steps
        self.mc_low = mc_low
        self.mc_high = mc_high if mc_high is not None else rollout_steps * 0.9
        #: environment parameter dimensionality (physics/terrain vector)
        self.env_dim = len(env_cls.DEFAULT)
        self.generator = generator or torch.Generator(
            device=self.device).manual_seed(0)
        self.pick_generator = pick_generator or torch.Generator().manual_seed(
            0)
        self.envs: List[torch.Tensor] = [torch.tensor(
            env_cls.DEFAULT, dtype=torch.float32, device=self.device)]
        self.agents: List[torch.Tensor] = [policy.init(
            torch.Generator().manual_seed(0), device=self.device)]
        # the novelty reference set: retired pairs stay here, so that
        # mutating back toward old environments scores low for good
        self.archive: List[np.ndarray] = [np.asarray(env_cls.DEFAULT,
                                                     dtype=float)]
        self.novelty_k = 3
        self.last_transfer_evals = 0
        self._es = EvolutionStrategy(
            self._eval_members, env_cls.reset,
            dim=policy.dim + self.env_dim, pop_size=pop_size, sigma=sigma,
            lr=lr, mesh=self.mesh, generator=self.generator)
        self.pop_size = self._es.pop_size
        self._runner = build_fused_runner(self._pinned_step, self._es.mesh,
                                          1, 1, generator=self.generator)

    # -- draws -----------------------------------------------------------
    def _reset(self, n: int):
        """n initial states: the minimal criterion's, the transfer
        matrix's (one an agent) and the proposal's."""
        return self.env_cls.reset(n, self.generator)

    def _pick_parent(self, n: int) -> int:
        return int(torch.randint(n, (), generator=self.pick_generator))

    def _mutation_noise(self):
        return torch.randn(self.env_dim, generator=self.generator,
                           device=self.device)

    # -- evaluation and the ES step --------------------------------------
    def _eval_members(self, thetas, states):
        """Returns (m,) of members ``thetas`` (m, policy.dim + env_dim),
        each under the environment vector in its tail."""
        d = self.policy.dim
        return self.env_cls.rollout_p(self.policy.act, thetas[:, d:],
                                      thetas[:, :d], states,
                                      max_steps=self.rollout_steps)

    def _eval_pair(self, env_params, theta, state):
        """The return of one agent on one environment from ``state``
        (a batch of one)."""
        return self.env_cls.rollout_p(self.policy.act, env_params[None],
                                      theta[None], state,
                                      max_steps=self.rollout_steps)[0]

    def _pinned_step(self, combined):
        """One ES generation of ``[theta, env]`` with the env tail pinned
        back: ES perturbs it, but the pair's environment is fixed."""
        new, _, _, _, stats = self._es._device_step_fn(
            combined, *self._es._ensure_opt_state(combined))
        d = self.policy.dim
        return torch.cat([new[:d], combined[d:]]), stats

    def _finetune(self, theta, env_params, steps: int):
        """ES with the env tail pinned back, shared by
        :meth:`optimize_pair` and the proposal stage of
        :meth:`transfer`: ``steps`` generations from a copy of
        ``theta`` on ``env_params``. Returns (new_theta, last stats)."""
        combined = torch.cat([theta, env_params])
        stats = None
        for _ in range(steps):
            combined, stats = self._runner(combined)
        return combined[:self.policy.dim], (None if stats is None
                                            else stats[0])

    def optimize_pair(self, idx: int, es_steps: int = 5) -> float:
        """ES-optimises agent ``idx`` on its environment; returns the
        last generation's mean fitness."""
        theta, stats = self._finetune(self.agents[idx], self.envs[idx],
                                      es_steps)
        self.agents[idx] = theta
        return float(stats[0])

    def transfer(self, proposal_steps: int = 1) -> int:
        """Evaluates every agent on every environment and adopts better
        agents, POET's two-stage transfer. Direct: the (n_env, n_agent)
        matrix in one batched rollout. Proposal: the best foreign agent
        of each environment is fine-tuned for ``proposal_steps`` ES
        generations there before it is compared with the incumbent
        (``proposal_steps=0``: direct only). Returns the number of
        adoptions; ``last_transfer_evals`` counts the proposal stage's
        evaluations."""
        n_env, n_agent = len(self.envs), len(self.agents)
        if n_env == 0 or n_agent < 2:
            self.last_transfer_evals = 0
            return 0
        # candidates and the matrix describe the same population: an
        # adoption below must not change what a later env compares
        agents_before = list(self.agents)
        envs, agents = torch.stack(self.envs), torch.stack(agents_before)
        states = self._reset(n_agent)
        returns = self.env_cls.rollout_p(
            self.policy.act, envs.repeat_interleave(n_agent, 0),
            agents.repeat(n_env, 1),
            states.repeat(n_env, *[1] * (states.dim() - 1)),
            max_steps=self.rollout_steps)
        matrix = returns.reshape(n_env, n_agent).cpu().numpy()
        transfers = 0
        proposal_evals = 0
        for e in range(n_env):
            best_agent = int(matrix[e].argmax())
            incumbent = matrix[e, e]
            # scaled by |incumbent|, so the test means something for
            # zero and negative fitness too
            margin = 0.05 * max(1.0, abs(float(incumbent)))
            if best_agent == e:
                continue
            candidate = agents_before[best_agent]
            cand_fit = matrix[e, best_agent]
            if proposal_steps > 0:
                tuned, _ = self._finetune(candidate, self.envs[e],
                                          proposal_steps)
                tuned_fit = float(self._eval_pair(self.envs[e], tuned,
                                                  self._reset(1)))
                proposal_evals += proposal_steps * self.pop_size + 1
                if tuned_fit > cand_fit:
                    candidate, cand_fit = tuned, tuned_fit
            if cand_fit > incumbent + margin:
                self.agents[e] = candidate
                transfers += 1
        self.last_transfer_evals = proposal_evals
        return transfers

    def novelty(self, env_params) -> float:
        """Mean distance to the k nearest environments of the archive."""
        cand = _host(env_params)
        dists = np.sort([
            float(np.linalg.norm(cand - seen)) for seen in self.archive
        ])
        k = min(self.novelty_k, len(dists))
        return float(np.mean(dists[:k]))

    def try_spawn_envs(self, n_candidates: int = 4,
                       max_admit: int = 2) -> int:
        """Mutates ``n_candidates`` environments of random parents, keeps
        those whose parent agent scores within [mc_low, mc_high] there
        (not trivial, not impossible), and admits up to ``max_admit`` in
        order of novelty, each scored against the archive as it grows.
        At capacity each admission retires the oldest pair (its env
        stays in the archive). Returns the number admitted."""
        passed = []
        for _ in range(n_candidates):
            parent = self._pick_parent(len(self.envs))
            cand = self.env_cls.mutate(self.envs[parent],
                                       noise=self._mutation_noise())
            score = float(self._eval_pair(cand, self.agents[parent],
                                          self._reset(1)))
            if self.mc_low <= score <= self.mc_high:
                # the parent agent itself: evictions below shift indices
                passed.append((self.agents[parent], cand))

        admitted = 0
        while passed and admitted < max_admit:
            scored = [(self.novelty(cand), i)
                      for i, (_agent, cand) in enumerate(passed)]
            best_novelty, best_i = max(scored)
            if admitted > 0 and best_novelty == 0.0:
                break  # exact duplicate of something already admitted
            parent_agent, cand = passed.pop(best_i)
            if len(self.envs) >= self.max_pairs:
                # retire the oldest pair (list order = creation order)
                self.envs.pop(0)
                self.agents.pop(0)
            self.envs.append(cand)
            self.agents.append(parent_agent)
            self.archive.append(_host(cand))
            admitted += 1
        return admitted

    def run(self, iterations: int, es_steps: int = 5,
            log: Optional[Callable[[str], None]] = None) -> List[dict]:
        """``iterations`` rounds of optimise, spawn and transfer; one
        record a round."""
        history = []
        for it in range(iterations):
            means = [self.optimize_pair(idx, es_steps)
                     for idx in range(len(self.envs))]
            spawned = self.try_spawn_envs()
            transfers = self.transfer()
            record = {
                "iteration": it,
                "pairs": len(self.envs),
                "mean_fitness": sum(means) / len(means),
                "spawned": spawned,
                "transfers": transfers,
                "transfer_evals": self.last_transfer_evals,
                "archive_size": len(self.archive),
            }
            history.append(record)
            if log:
                log(
                    f"poet iter {it}: pairs={record['pairs']} "
                    f"mean={record['mean_fitness']:.1f} "
                    f"spawned={spawned} transfers={transfers}"
                )
        return history
