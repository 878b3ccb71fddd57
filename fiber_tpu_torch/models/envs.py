"""Batched environments: CartPole as a step function on a (pop, 4)
state, and the deceptive point maze on (pop, 2) positions.

Counterpart of ``CartPole``, ``_survival_scan`` and ``DeceptiveMaze`` in
``fiber_tpu/models/envs.py``: Gym CartPole-v1 dynamics, and an episode
of a fixed number of steps with an alive mask (reward 1 while alive;
once done, a row's state freezes and it stops scoring); the maze's wall
physics. Where JAX scans one episode and vmaps it over the population,
the port loops over the steps of the whole population at once. The
rollouts write no tensor in place, so ``torch.func.vmap`` can map them
over single items too (``parallel/dmap.py``).
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
        total = total + (~done).float()
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


class DeceptiveMaze:
    """Deceptive point maze, the novelty-search lineage's domain: a point
    starts near the origin, the goal sits directly above it behind a
    wall spanning ``|x| <= WALL_HALF`` at ``y = WALL_Y``, so the fitness
    gradient presses into the wall and the way round leads away from
    the goal first. Observations are the position and the goal offset;
    actions a velocity, ``tanh(policy) * SPEED``. A step whose path
    crosses the wall parks at the crossing's x, just on its starting
    side. :meth:`rollout_xy` gives the final positions: fitness is the
    negative goal distance and the behavior the position itself."""

    obs_dim = 4
    act_dim = 2  # (vx, vy), tanh-squashed continuous
    max_steps = 64

    GOAL = (0.0, 2.0)
    SPEED = 0.15
    WALL_Y = 1.0
    WALL_HALF = 1.0

    @classmethod
    def reset(cls, n: int, generator: Optional[torch.Generator] = None,
              device=None):
        """(n, 2) start positions, ``0.05 * N(0, 1)``, drawn from
        ``generator`` on its device; without one, on ``device`` (CUDA
        unless the caller asks for the CPU)."""
        dev = (generator.device if generator is not None
               else resolve_device(device))
        return 0.05 * torch.randn(n, 2, generator=generator, device=dev)

    @classmethod
    def rollout_xy(cls, apply_fn: Callable, flat_params, pos0,
                   max_steps: Optional[int] = None):
        """Final positions (pop, 2) after ``max_steps`` policy-driven
        steps from ``pos0`` (pop, 2). ``apply_fn(flat_params (pop, dim),
        obs (pop, 4)) -> (pop, 2)``."""
        gx, gy = cls.GOAL
        x, y = pos0.unbind(-1)
        for _ in range(max_steps or cls.max_steps):
            obs = torch.stack([x, y, gx - x, gy - y], dim=-1)
            v = torch.tanh(apply_fn(flat_params, obs)) * cls.SPEED
            nx, ny = x + v[:, 0], y + v[:, 1]
            # A step crosses the wall where its segment meets the wall
            # plane inside |x| <= WALL_HALF (the crossing's x, not the
            # endpoint's: that would cut the corner); a step parallel to
            # the wall never crosses (t = 2).
            dy = ny - y
            moving = dy.abs() > 1e-12
            t = torch.where(moving, (cls.WALL_Y - y)
                            / torch.where(moving, dy, 1.0), 2.0)
            x_cross = x + t * (nx - x)
            crosses = (t >= 0.0) & (t <= 1.0) \
                & (x_cross.abs() <= cls.WALL_HALF)
            stop_y = torch.where(y < cls.WALL_Y, cls.WALL_Y - 1e-3,
                                 cls.WALL_Y + 1e-3)
            x = torch.where(crosses, x_cross, nx)
            y = torch.where(crosses, stop_y, ny)
        return torch.stack([x, y], dim=-1)

    @classmethod
    def fitness_and_behavior(cls, apply_fn: Callable, flat_params, pos0,
                             max_steps: Optional[int] = None):
        """(negative final goal distance (pop,), final position (pop,
        2)): the ``(fitness, behavior)`` pair that the novelty and
        MAP-Elites examples evaluate."""
        pos = cls.rollout_xy(apply_fn, flat_params, pos0, max_steps)
        gx, gy = cls.GOAL       # scalars: no host-to-device copy
        d2 = (pos[:, 0] - gx) ** 2 + (pos[:, 1] - gy) ** 2
        return -torch.sqrt(d2), pos

    @classmethod
    def rollout(cls, apply_fn: Callable, flat_params, pos0,
                max_steps: Optional[int] = None):
        """Fitness only: the negative final distance to the goal (pop,)."""
        return cls.fitness_and_behavior(apply_fn, flat_params, pos0,
                                        max_steps)[0]
