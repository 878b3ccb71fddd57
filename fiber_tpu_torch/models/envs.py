"""Batched environments: CartPole as a step function on a (pop, 4) state.

Counterpart of ``CartPole`` and ``_survival_scan`` in
``fiber_tpu/models/envs.py``: Gym CartPole-v1 dynamics, and an episode
of a fixed number of steps with an alive mask (reward 1 while alive;
once done, a row's state freezes and it stops scoring). Where JAX scans
one episode and vmaps it over the population, the port loops over the
steps of the whole population at once.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fiber_tpu_torch.device import resolve_device


def survival_rollout(step_fn: Callable, act_fn: Callable, state0,
                     steps: int):
    """Total reward (pop,) f32 of the masked episode loop.
    ``act_fn(state) -> actions (pop,)``;
    ``step_fn(state, actions) -> (state', terminated (pop,) bool)``."""
    state = state0
    done = torch.zeros(state0.shape[0], dtype=torch.bool,
                       device=state0.device)
    total = torch.zeros(state0.shape[0], dtype=torch.float32,
                        device=state0.device)
    for _ in range(steps):
        next_state, terminated = step_fn(state, act_fn(state))
        total += (~done).float()
        state = torch.where(done[:, None], state, next_state)
        done = done | terminated
    return total


class CartPole:
    obs_dim = 4
    act_dim = 2
    max_steps = 500

    # physics constants (Gym CartPole-v1)
    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    length = 0.5          # half pole length
    force_mag = 10.0
    tau = 0.02
    theta_threshold = 12 * 3.141592653589793 / 180.0
    x_threshold = 2.4

    @classmethod
    def reset(cls, n: int, generator: Optional[torch.Generator] = None,
              device=None):
        """(n, 4) initial states, uniform in [-0.05, 0.05), drawn from
        ``generator`` on its device; without one, on ``device`` (CUDA
        unless the caller asks for the CPU)."""
        dev = (generator.device if generator is not None
               else resolve_device(device))
        u = torch.rand(n, 4, generator=generator, device=dev)
        return u * 0.1 - 0.05

    @classmethod
    def step(cls, state, action):
        """One physics step of every row. action (pop,) in {0, 1}.
        Returns (state (pop, 4), terminated (pop,))."""
        x, x_dot, theta, theta_dot = state.unbind(-1)
        force = torch.where(action == 1, cls.force_mag, -cls.force_mag)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        total_mass = cls.masscart + cls.masspole
        polemass_length = cls.masspole * cls.length

        temp = (force + polemass_length * theta_dot ** 2 * sintheta) \
            / total_mass
        thetaacc = (cls.gravity * sintheta - costheta * temp) / (
            cls.length * (4.0 / 3.0 - cls.masspole * costheta ** 2
                          / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass

        x = x + cls.tau * x_dot
        x_dot = x_dot + cls.tau * xacc
        theta = theta + cls.tau * theta_dot
        theta_dot = theta_dot + cls.tau * thetaacc
        new_state = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        terminated = (x.abs() > cls.x_threshold) \
            | (theta.abs() > cls.theta_threshold)
        return new_state, terminated

    @classmethod
    def rollout(cls, act_fn: Callable, flat_params, state0,
                max_steps: Optional[int] = None):
        """Total episode reward (pop,) of deterministic policies from
        initial states (pop, 4). ``act_fn(flat_params, obs) -> actions``
        with flat_params (pop, dim)."""
        return survival_rollout(
            cls.step, lambda s: act_fn(flat_params, s), state0,
            max_steps or cls.max_steps)
