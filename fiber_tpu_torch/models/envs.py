"""Batched environments: each steps a whole population at once.

Counterpart of ``fiber_tpu/models/envs.py``: CartPole (Gym CartPole-v1
dynamics) and ``ParamCartPole`` with its physics vector as an evolvable
parameter, Pendulum, the pixel chase, the terrain walkers
(``ParamHillWalker``, ``ParamBipedWalker``), the deceptive maze, the
masked survival episode (``_survival_scan``: reward 1 while alive; once
done, a row's state and the policy's carry freeze and it stops
scoring), ``rollout_recurrent`` and the bounded mutation the POET envs
share. Where JAX scans one episode and vmaps it over the population,
the port loops over the steps of the whole population at once; a
``rollout_p`` takes its environment parameters as one ``(k,)`` vector
for every row or as ``(pop, k)``, one vector a row. The rollouts write
no tensor in place, so ``torch.func.vmap`` can map them over single
items too (``parallel/dmap.py``), and make no tensor from host data, so
a CUDA graph can capture them (constants come from :func:`_const`,
made once per device).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch

from fiber_tpu_torch.device import resolve_device


def _draw_device(generator: Optional[torch.Generator], device):
    """Where a reset draws: on ``generator``'s device, else on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    return generator.device if generator is not None else resolve_device(
        device)


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    """An f32 constant on ``device``, made once: a tensor made from host
    data inside a CUDA-graph capture would be a host-to-device copy,
    which a capture refuses. The runners' warm-up makes it first."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def mutate_bounded(env_params, low, high, scale: float = 0.15,
                   generator: Optional[torch.Generator] = None,
                   noise=None):
    """The POET envs' mutation: ``clip(p + N(0, 1) * scale * (high -
    low), low, high)`` in f32. ``noise`` (shaped like ``low``) is drawn
    from ``generator`` on the parameters' device when not given."""
    dev = env_params.device
    low, high = _const(tuple(low), dev), _const(tuple(high), dev)
    if noise is None:
        if generator is None:
            raise ValueError("mutate_bounded needs a generator or noise")
        noise = torch.randn(low.shape, generator=generator, device=dev)
    return torch.clamp(env_params + noise * scale * (high - low), low, high)


def _freeze(done, old, new):
    """``new`` on the rows still running, ``old`` on the finished ones."""
    return torch.where(done.reshape(-1, *[1] * (new.dim() - 1)), old, new)


def survival_rollout(step_fn: Callable, act_step_fn: Callable, state0,
                     carry0, steps: int):
    """Total reward (pop,) f32 of the masked episode loop.
    ``act_step_fn(carry, state) -> (carry', actions (pop,))`` with the
    policy's carry (None for a stateless policy, else a tensor whose
    first axis is the population);
    ``step_fn(state, actions) -> (state', terminated (pop,) bool)``.
    A finished row's state and carry freeze."""
    state, carry = state0, carry0
    done = torch.zeros(state0.shape[0], dtype=torch.bool,
                       device=state0.device)
    total = torch.zeros(state0.shape[0], dtype=torch.float32,
                        device=state0.device)
    for _ in range(steps):
        new_carry, action = act_step_fn(carry, state)
        next_state, terminated = step_fn(state, action)
        total = total + (~done).float()
        state = _freeze(done, state, next_state)
        if carry is not None:
            carry = _freeze(done, carry, new_carry)
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
        u = torch.rand(n, 4, generator=generator,
                       device=_draw_device(generator, device))
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
            cls.step, lambda c, s: (c, act_fn(flat_params, s)), state0,
            None, max_steps or cls.max_steps)


class ParamCartPole(CartPole):
    """CartPole with mutable physics, the substrate of POET's env/agent
    co-evolution: the evolvable parameters are the physics vector
    ``[gravity, pole_half_length, force_mag, masspole]``; a heavier or
    longer pole and a weaker cart make a harder env."""

    #: default physics vector (matches CartPole-v1)
    DEFAULT = (9.8, 0.5, 10.0, 0.1)
    PARAM_LOW = (4.0, 0.25, 4.0, 0.05)
    PARAM_HIGH = (19.0, 1.5, 14.0, 0.6)

    @classmethod
    def step_p(cls, env_params, state, action):
        """One physics step of every row under ``env_params``: ``(4,)``
        for every row or ``(pop, 4)``, one vector a row. Returns (state
        (pop, 4), terminated (pop,))."""
        gravity, length, force_mag, masspole = env_params.unbind(-1)
        x, x_dot, theta, theta_dot = state.unbind(-1)
        force = torch.where(action == 1, force_mag, -force_mag)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        total_mass = cls.masscart + masspole
        polemass_length = masspole * length

        temp = (force + polemass_length * theta_dot ** 2 * sintheta) \
            / total_mass
        thetaacc = (gravity * sintheta - costheta * temp) / (
            length * (4.0 / 3.0 - masspole * costheta ** 2 / total_mass)
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
    def rollout_p(cls, act_fn: Callable, env_params, flat_params, state0,
                  max_steps: Optional[int] = None):
        """Episode reward (pop,) under ``env_params`` ((4,) or (pop, 4))
        from initial states (pop, 4)."""
        return survival_rollout(
            lambda s, a: cls.step_p(env_params, s, a),
            lambda c, s: (c, act_fn(flat_params, s)), state0, None,
            max_steps or cls.max_steps)

    @classmethod
    def mutate(cls, env_params, generator: Optional[torch.Generator] = None,
               scale: float = 0.15, noise=None):
        """The physics vector perturbed within bounds (POET's env
        mutation; see :func:`mutate_bounded`)."""
        return mutate_bounded(env_params, cls.PARAM_LOW, cls.PARAM_HIGH,
                              scale, generator, noise)


class Pendulum:
    """Gym Pendulum: a shaped reward (minus the angle, speed and torque
    cost) and a continuous torque, ``act_fn`` giving (pop,) torques."""

    obs_dim = 3
    act_dim = 1
    max_steps = 200

    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0

    @classmethod
    def reset(cls, n: int, generator: Optional[torch.Generator] = None,
              device=None):
        """(n, 2) states (theta, theta_dot), uniform in [-pi, pi) x
        [-1, 1), drawn as :meth:`CartPole.reset` draws."""
        dev = _draw_device(generator, device)
        u = torch.rand(n, 2, generator=generator, device=dev)
        return (2.0 * u - 1.0) * _const((math.pi, 1.0), dev)

    @classmethod
    def obs(cls, state):
        theta, theta_dot = state.unbind(-1)
        return torch.stack([torch.cos(theta), torch.sin(theta), theta_dot],
                           dim=-1)

    @classmethod
    def step(cls, state, torque):
        """(state', reward) of every row for torques (pop,)."""
        theta, theta_dot = state.unbind(-1)
        u = torch.clamp(torque, -cls.max_torque, cls.max_torque)
        cost = (
            _angle_normalize(theta) ** 2
            + 0.1 * theta_dot ** 2
            + 0.001 * u ** 2
        )
        new_theta_dot = theta_dot + (
            3 * cls.g / (2 * cls.length) * torch.sin(theta)
            + 3.0 / (cls.m * cls.length ** 2) * u
        ) * cls.dt
        new_theta_dot = torch.clamp(new_theta_dot, -cls.max_speed,
                                    cls.max_speed)
        new_theta = theta + new_theta_dot * cls.dt
        return torch.stack([new_theta, new_theta_dot], dim=-1), -cost

    @classmethod
    def rollout(cls, act_fn: Callable, flat_params, state0,
                max_steps: Optional[int] = None):
        """Total reward (pop,) from initial states (pop, 2);
        ``act_fn(flat_params, obs (pop, 3)) -> torques (pop,)``."""
        state = state0
        total = torch.zeros(state0.shape[0], dtype=torch.float32,
                            device=state0.device)
        for _ in range(max_steps or cls.max_steps):
            torque = act_fn(flat_params, cls.obs(state)).reshape(-1)
            state, reward = cls.step(state, torque)
            total = total + reward
        return total


def _angle_normalize(x):
    # a floor modulo, as JAX's %: torch.remainder, not torch.fmod
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


class PixelChase:
    """Procedural pixel-observation env for ConvNet-policy ES: an agent
    blob chases a target blob on an H x W grid; observations are
    rendered single-channel images (pop, H, W, 1), actions the four
    moves and stay, and the reward the negative distance over H."""

    H = 24
    W = 24
    obs_shape = (24, 24, 1)
    act_dim = 5
    max_steps = 60

    _MOVES = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))

    @classmethod
    def reset(cls, n: int, generator: Optional[torch.Generator] = None,
              device=None):
        """(n, 4): the agent's (y, x), then the target's, uniform in
        [2, H - 3)."""
        u = torch.rand(n, 4, generator=generator,
                       device=_draw_device(generator, device))
        return 2.0 + u * (cls.H - 5.0)

    @classmethod
    def _render(cls, agent_yx, target_yx):
        """(pop, H, W, 1) images of agents and targets (pop, 2)."""
        dev = agent_yx.device
        ys = torch.arange(cls.H, dtype=torch.float32, device=dev)[:, None]
        xs = torch.arange(cls.W, dtype=torch.float32, device=dev)[None, :]

        def blob(yx):
            return torch.exp(
                -((ys - yx[:, 0, None, None]) ** 2
                  + (xs - yx[:, 1, None, None]) ** 2) / 4.0)

        return (blob(agent_yx) + -blob(target_yx))[..., None]

    @classmethod
    def rollout(cls, act_fn: Callable, flat_params, state0,
                max_steps: Optional[int] = None):
        """Total reward (pop,) from (pop, 4) starts (:meth:`reset`);
        ``act_fn(flat_params, obs (pop, H, W, 1)) -> actions (pop,)``."""
        agent, target = state0[:, :2], state0[:, 2:]
        moves = _const(cls._MOVES, agent.device)
        total = torch.zeros(state0.shape[0], dtype=torch.float32,
                            device=state0.device)
        for _ in range(max_steps or cls.max_steps):
            action = act_fn(flat_params, cls._render(agent, target))
            agent = torch.clamp(agent + moves[action], 0.0,
                                float(cls.H - 1))
            dist = torch.sqrt(((agent - target) ** 2).sum(-1))
            total = total + -dist / cls.H
        return total

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
        return 0.05 * torch.randn(n, 2, generator=generator,
                                  device=_draw_device(generator, device))

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


class ParamHillWalker:
    """Terrain-parameterised 1-D walker, POET's co-evolution shape: a
    point mass drives along ``h(x) = sum_i a_i sin(f_i x)``, whose
    amplitudes ``a_i`` are the env's parameters. Observations are the
    velocity and the slope at, half a metre and a metre ahead of the
    agent; actions push back, coast or push forward; fitness is the
    final ``x``."""

    obs_dim = 4
    act_dim = 3  # push back / coast / push forward
    max_steps = 200

    dt = 0.05
    friction = 0.5
    force_mag = 4.0
    gravity = 9.8

    #: fixed incommensurate bump frequencies; env params are amplitudes
    FREQS = (0.5, 0.9, 1.4, 2.1, 3.1, 4.3)
    DEFAULT = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)  # flat ground
    PARAM_LOW = (-1.2,) * 6
    PARAM_HIGH = (1.2,) * 6

    @classmethod
    def slope(cls, env_params, x):
        """dh/dx (pop,) at positions x (pop,), analytic over FREQS;
        ``env_params`` (6,) or (pop, 6)."""
        freqs = _const(cls.FREQS, x.device)
        return (env_params * freqs
                * torch.cos(freqs * x[..., None])).sum(-1)

    @classmethod
    def reset(cls, n: int, generator: Optional[torch.Generator] = None,
              device=None):
        """(n,) start positions ``0.1 * N(0, 1)``."""
        return 0.1 * torch.randn(n, generator=generator,
                                 device=_draw_device(generator, device))

    @classmethod
    def rollout_p(cls, act_fn: Callable, env_params, flat_params, x0,
                  max_steps: Optional[int] = None):
        """Final positions (pop,) on the terrain ``env_params`` ((6,) or
        (pop, 6)) from starts x0 (pop,), at rest."""
        x, v = x0, torch.zeros_like(x0)
        for _ in range(max_steps or cls.max_steps):
            here = cls.slope(env_params, x)
            obs = torch.stack([v, here, cls.slope(env_params, x + 0.5),
                               cls.slope(env_params, x + 1.0)], dim=-1)
            action = act_fn(flat_params, obs)
            force = (action.float() - 1.0) * cls.force_mag
            acc = force - cls.gravity * here - cls.friction * v
            v = v + cls.dt * acc
            x = x + cls.dt * v
        return x

    @classmethod
    def mutate(cls, env_params, generator: Optional[torch.Generator] = None,
               scale: float = 0.15, noise=None):
        """The terrain amplitudes perturbed within bounds (POET's env
        mutation; see :func:`mutate_bounded`)."""
        return mutate_bounded(env_params, cls.PARAM_LOW, cls.PARAM_HIGH,
                              scale, generator, noise)


class ParamBipedWalker:
    """Planar biped on a parameterised obstacle course, POET's published
    domain shape (a modified BipedalWalker-Hardcore). A hull (x, y, vx,
    vy, phi, omega) rides two massless telescoping legs (world-frame hip
    angles theta_i, lengths L_i) with spring-damper ground contact whose
    forces torque the hull. Actions are 16 bang-bang combinations of
    (hip1, hip2, dL1, dL2) rate signs, the bits of the argmax. Env
    params: 4 roughness amplitudes, stump height and gap depth (all
    zero: flat ground). Fitness is the furthest ``x`` reached before a
    fall; a fallen row freezes."""

    obs_dim = 14
    act_dim = 16
    max_steps = 400

    dt = 0.025
    gravity = 9.8
    mass = 1.0
    inertia = 0.5
    hip_rate = 3.0       # rad/s
    len_rate = 1.5       # m/s
    theta_lim = 0.9
    len_low, len_high = 0.5, 1.2
    k_contact = 120.0
    d_contact = 6.0
    k_friction = 4.0
    omega_damp = 1.0

    FREQS = (0.4, 0.8, 1.5, 2.7)
    DEFAULT = (0.0,) * 6
    PARAM_LOW = (0.0,) * 6
    PARAM_HIGH = (0.4, 0.4, 0.3, 0.2, 0.5, 0.6)

    @classmethod
    def height(cls, env_params, x):
        """Terrain height at x: roughness + periodic stumps - periodic
        gaps; obstacles start about 3 m from the spawn. ``env_params``
        broadcasts against ``x`` with the 6 parameters last: (6,) for
        any x, or (pop, 6) for x (pop,) (and (pop, 1, 6) for x (pop,
        m))."""
        p = env_params
        freqs = _const(cls.FREQS, x.device)
        rough = (p[..., :4] * torch.sin(freqs * x[..., None])).sum(-1)
        stump = p[..., 4] * torch.exp(
            -torch.sin(0.5 * (x - 3.0)) ** 2 / 0.01)
        gap = p[..., 5] * torch.exp(
            -torch.sin(0.35 * (x - 5.0)) ** 2 / 0.02)
        return rough + stump - gap

    @classmethod
    def reset(cls, n: int, generator: Optional[torch.Generator] = None,
              device=None):
        """(n, 2) jitter ``0.02 * N(0, 1)`` of the hull angle and the
        first hip; :meth:`rollout_p` builds the start from it."""
        return 0.02 * torch.randn(n, 2, generator=generator,
                                  device=_draw_device(generator, device))

    @classmethod
    def _leg_forces(cls, x, y, vx, vy, th, L, dth, dL, foot_x, foot_y,
                    foot_h):
        """(friction, normal, torque) of one leg's ground contact, given
        its foot's position and the terrain height under it."""
        vfx = vx + dL * torch.sin(th) + L * torch.cos(th) * dth
        vfy = vy - dL * torch.cos(th) + L * torch.sin(th) * dth
        pen = foot_h - foot_y
        contact = pen > 0.0
        normal = torch.where(
            contact,
            torch.clamp(cls.k_contact * pen - cls.d_contact * vfy, min=0.0),
            0.0)
        friction = torch.where(
            contact,
            torch.clamp(-cls.k_friction * vfx, -0.8 * normal, 0.8 * normal),
            0.0)
        rx, ry = foot_x - x, foot_y - y
        return friction, normal, rx * normal - ry * friction

    @classmethod
    def rollout_p(cls, act_fn: Callable, env_params, flat_params, jitter,
                  max_steps: Optional[int] = None):
        """Furthest ``x`` (pop,) reached on the course ``env_params``
        ((6,) or (pop, 6)) from the jitter (pop, 2) of :meth:`reset`."""
        # the 7 heights a step reads at once: (pop, 7) against (pop, 1, 6)
        p7 = env_params if env_params.dim() == 1 else env_params[:, None]
        zero = torch.zeros_like(jitter[:, 0])
        y0 = cls.height(env_params, zero) + 1.0
        # state: x, y, vx, vy, phi, omega, th1, th2, L1, L2
        state = torch.stack([
            zero, y0, zero, zero, jitter[:, 0], zero,
            0.15 + jitter[:, 1], zero - 0.15, zero + 1.0, zero + 1.0,
        ], dim=-1)
        done = torch.zeros_like(zero, dtype=torch.bool)
        best_x = zero
        for _ in range(max_steps or cls.max_steps):
            x, y, vx, vy, phi, om, th1, th2, L1, L2 = state.unbind(-1)
            f1x, f1y = x + L1 * torch.sin(th1), y - L1 * torch.cos(th1)
            f2x, f2y = x + L2 * torch.sin(th2), y - L2 * torch.cos(th2)
            h1, h2, a1, b1, a2, b2, h0 = cls.height(p7, torch.stack([
                f1x, f2x, x + 0.3 + 0.1, x + 0.3 - 0.1, x + 0.8 + 0.1,
                x + 0.8 - 0.1, x], dim=-1)).unbind(-1)
            obs = torch.stack([
                vx / 3.0, vy / 3.0, om, torch.sin(phi), torch.cos(phi),
                th1, th2, L1, L2,
                # previous-step contact proxies: current penetration
                (h1 >= f1y).float(), (h2 >= f2y).float(),
                (a1 - b1) / 0.2, (a2 - b2) / 0.2, y - h0,
            ], dim=-1)
            action = act_fn(flat_params, obs)

            def bit(k):
                return 2.0 * ((action >> k) & 1).float() - 1.0

            dth1 = bit(3) * cls.hip_rate
            dth2 = bit(2) * cls.hip_rate
            dL1 = bit(1) * cls.len_rate
            dL2 = bit(0) * cls.len_rate
            fr1, n1, t1 = cls._leg_forces(x, y, vx, vy, th1, L1, dth1, dL1,
                                          f1x, f1y, h1)
            fr2, n2, t2 = cls._leg_forces(x, y, vx, vy, th2, L2, dth2, dL2,
                                          f2x, f2y, h2)

            ax = (fr1 + fr2) / cls.mass
            ay = (n1 + n2) / cls.mass - cls.gravity
            alpha = (t1 + t2) / cls.inertia - cls.omega_damp * om

            nvx = vx + cls.dt * ax
            nvy = vy + cls.dt * ay
            nom = om + cls.dt * alpha
            nx = x + cls.dt * nvx
            ny = y + cls.dt * nvy
            nphi = phi + cls.dt * nom
            nth1 = torch.clamp(th1 + cls.dt * dth1, -cls.theta_lim,
                               cls.theta_lim)
            nth2 = torch.clamp(th2 + cls.dt * dth2, -cls.theta_lim,
                               cls.theta_lim)
            nL1 = torch.clamp(L1 + cls.dt * dL1, cls.len_low, cls.len_high)
            nL2 = torch.clamp(L2 + cls.dt * dL2, cls.len_low, cls.len_high)
            new_state = torch.stack([
                nx, ny, nvx, nvy, nphi, nom, nth1, nth2, nL1, nL2,
            ], dim=-1)
            fell = ((ny - cls.height(env_params, nx) < 0.3)
                    | (nphi.abs() > 1.2))
            state = _freeze(done, state, new_state)
            best_x = torch.where(done, best_x, torch.maximum(best_x, nx))
            done = done | fell
        return best_x

    @classmethod
    def mutate(cls, env_params, generator: Optional[torch.Generator] = None,
               scale: float = 0.15, noise=None):
        """The course parameters perturbed within bounds (POET's env
        mutation; difficulty grows from flat ground)."""
        return mutate_bounded(env_params, cls.PARAM_LOW, cls.PARAM_HIGH,
                              scale, generator, noise)


def rollout_recurrent(env_cls, policy, flat_params, state0,
                      max_steps: Optional[int] = None):
    """Episode reward (pop,) of a recurrent policy
    (``init_carry``/``act_step``, e.g. ``GRUPolicy``) on a survival env
    with ``step(state, action) -> (state, terminated)`` (CartPole and
    its subclasses), from initial states ``state0``: the masked loop of
    :func:`survival_rollout` with the policy's hidden state as its
    carry, frozen with the state once a row is done."""
    return survival_rollout(
        env_cls.step,
        lambda h, state: policy.act_step(flat_params, h, state),
        state0, policy.init_carry(state0.shape[0], device=state0.device),
        max_steps or env_cls.max_steps)
