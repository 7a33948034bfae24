"""Langevin (classic and BAOAB), velocity Verlet and r-RESPA integration
over a written-out replica dimension.

The classic scheme matches OpenMM's ``LangevinIntegrator``:

    a = exp(-gamma dt)
    v <- a v + (1 - a) f / (m gamma) + sqrt(kT (1 - a^2) / m) xi
    x <- x + v dt

``middle`` is OpenMM's LangevinMiddleIntegrator (BAOAB splitting). With a
ConstraintSet, SHAKE follows every position update with its correction
folded into the velocities, then RATTLE.

States are [..., N, 3] (replicas are [R, N, 3]); the Gaussian noise xi
comes from the state's explicit ``torch.Generator``, or from a ``noise``
tensor the caller passes (the tests feed both packages the same numbers
this way). On the CPU a segment is a Python loop of steps, the tests'
oracle. On the card ``run_segment``, ``run_trajectory`` and
``run_respa_segment`` replay CUDA graphs of blocks of steps
(``mm/graphs.py``), each block's noise drawn from the generator at once
or copied from the caller's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..units import BOLTZ
from . import graphs
from .constraints import apply_rattle, apply_shake


class MDState(NamedTuple):
    positions: torch.Tensor    # [..., N, 3] nm
    velocities: torch.Tensor   # [..., N, 3] nm/ps
    generator: Optional[torch.Generator] = None  # noise source


def initialize_state(generator: torch.Generator, positions, masses,
                     temperature) -> MDState:
    """Maxwell-Boltzmann velocities at ``temperature`` for [..., N, 3]."""
    sigma_v = torch.sqrt(BOLTZ * temperature / masses)[:, None]
    z = torch.randn(positions.shape, generator=generator,
                    dtype=positions.dtype, device=positions.device)
    return MDState(positions, sigma_v * z, generator)


def _constrain(constraints, x_ref, x_new, v, dt):
    """SHAKE the positions and fold the correction into velocities."""
    x_c, _ = apply_shake(constraints, x_ref, x_new)
    v = v + (x_c - x_new) / dt
    v, _ = apply_rattle(constraints, x_c, v)
    return x_c, v


def _normal(v, gen, noise):
    if noise is not None:
        return noise
    return torch.randn(v.shape, generator=gen, dtype=v.dtype,
                       device=v.device)


def make_langevin_step(force_fn: Callable, masses, dt, friction,
                       temperature, scheme: str = "classic",
                       constraints=None):
    """Build one Langevin step ``step(state, noise=None) -> state``.

    force_fn(positions) -> forces [..., N, 3] (kJ/mol/nm). masses [N] amu,
    dt ps, friction 1/ps, temperature K: a number, or a tensor that
    broadcasts against [..., N, 1] (per-replica temperatures are [R, 1, 1]);
    a tensor is read at every step, so a recorded segment takes new
    temperatures copied into it.
    ``constraints``: an optional ConstraintSet (SHAKE after position
    updates, the correction folded into velocities, then RATTLE).
    """
    inv_m = (1.0 / masses)[:, None]
    a = torch.exp(torch.tensor(-friction * dt, dtype=masses.dtype,
                               device=masses.device))
    # friction == 0 would make the classic force term 0/0; use the
    # ballistic limit (1-a)/gamma -> dt. The friction != 0 expression
    # keeps the reference's operation order: a one-ulp reorder sends f32
    # trajectories elsewhere.
    zero_friction = friction == 0.0

    if scheme == "classic":
        def step(state: MDState, noise=None) -> MDState:
            x, v, gen = state
            f = force_fn(x)
            noise = _normal(v, gen, noise)
            kick = (dt * f * inv_m if zero_friction
                    else (1.0 - a) * f * inv_m / friction)
            kT = BOLTZ * temperature
            v = (a * v + kick
                 + torch.sqrt(kT * (1.0 - a * a) * inv_m) * noise)
            x_new = x + v * dt
            if constraints is not None:
                x_new, v = _constrain(constraints, x, x_new, v, dt)
            return MDState(x_new, v, gen)
    elif scheme == "middle":
        def step(state: MDState, noise=None) -> MDState:
            x, v, gen = state
            f = force_fn(x)
            v = v + dt * f * inv_m
            x1 = x + 0.5 * dt * v
            if constraints is not None:
                x1, v = _constrain(constraints, x, x1, v, 0.5 * dt)
            noise = _normal(v, gen, noise)
            kT = BOLTZ * temperature
            v = a * v + torch.sqrt(kT * (1.0 - a * a) * inv_m) * noise
            x2 = x1 + 0.5 * dt * v
            if constraints is not None:
                x2, v = _constrain(constraints, x1, x2, v, 0.5 * dt)
            return MDState(x2, v, gen)
    else:
        raise ValueError(f"unknown Langevin scheme {scheme!r}")
    return step


def make_verlet_step(force_fn: Callable, masses, dt, constraints=None):
    """Velocity Verlet (NVE), optionally with SHAKE/RATTLE constraints.
    The step takes ``noise`` like the Langevin steps and ignores it."""
    inv_m = (1.0 / masses)[:, None]

    def step(state: MDState, noise=None) -> MDState:
        x, v, gen = state
        f = force_fn(x)
        v_half = v + 0.5 * dt * f * inv_m
        x_new = x + dt * v_half
        if constraints is not None:
            x_new, v_half = _constrain(constraints, x, x_new, v_half, dt)
        f_new = force_fn(x_new)
        v_new = v_half + 0.5 * dt * f_new * inv_m
        if constraints is not None:
            v_new, _ = apply_rattle(constraints, x_new, v_new)
        return MDState(x_new, v_new, gen)

    return step


def _check_noise(noise, n_steps):
    if noise is not None and noise.shape[0] != n_steps:
        raise ValueError(f"noise has {noise.shape[0]} steps, not {n_steps}")


def _recorded(state: MDState) -> bool:
    """Whether a segment of ``state`` runs as graph replays: on the card,
    and not already inside a recording (r-RESPA's inner steps)."""
    return state.positions.is_cuda and not graphs.recording()


def langevin_segment(step_fn: Callable, state: MDState, frames=False):
    """A :class:`graphs.Segment` of ``step_fn`` over buffers shaped like
    ``state``, carrying (positions, velocities), with a noise block of
    the velocities' shape."""
    gen = state.generator

    def advance(carry, noise):
        s = step_fn(MDState(carry[0], carry[1], gen), noise)
        return s.positions, s.velocities

    return graphs.Segment(advance, (state.positions, state.velocities),
                          noise_shape=state.velocities.shape, frames=frames)


def run_segment(step_fn: Callable, state: MDState, n_steps: int,
                noise=None) -> MDState:
    """Run ``n_steps`` steps; ``noise`` is None or [n_steps, ..., N, 3].
    On the card the steps are graph replays; with ``noise`` None each
    block's noise is drawn from the state's generator."""
    _check_noise(noise, n_steps)
    if _recorded(state):
        x, v = langevin_segment(step_fn, state).run(
            (state.positions, state.velocities), n_steps, noise=noise,
            generator=state.generator)
        return MDState(x, v, state.generator)
    for s in range(n_steps):
        state = step_fn(state, None if noise is None else noise[s])
    return state


def run_trajectory(step_fn: Callable, state: MDState, n_steps: int,
                   record_every: int = 1, noise=None):
    """Run and record positions every ``record_every`` steps.

    Returns (final_state, positions [n_steps // record_every, ..., N, 3]).
    ``n_steps`` must be a multiple of ``record_every``: silently simulating
    fewer steps than asked would corrupt any caller that trusts the final
    state. On the card the frames are copied out of the recorded blocks'
    per-step position buffer."""
    if n_steps % record_every:
        raise ValueError(
            f"n_steps={n_steps} is not a multiple of "
            f"record_every={record_every}; the trajectory would silently "
            f"stop at {(n_steps // record_every) * record_every} steps")
    _check_noise(noise, n_steps)
    frames = []
    if _recorded(state):
        def keep(start, length, buf):
            for u in range(length):
                if (start + u + 1) % record_every == 0:
                    frames.append(buf[u].clone())

        x, v = langevin_segment(step_fn, state, frames=True).run(
            (state.positions, state.velocities), n_steps, noise=noise,
            generator=state.generator, on_block=keep)
        return MDState(x, v, state.generator), torch.stack(frames)
    for s in range(n_steps):
        state = step_fn(state, None if noise is None else noise[s])
        if (s + 1) % record_every == 0:
            frames.append(state.positions)
    return state, torch.stack(frames)


def kinetic_energy(state: MDState, masses):
    m = masses[:, None]
    return 0.5 * (m * state.velocities ** 2).sum((-2, -1))


def instantaneous_temperature(state: MDState, masses):
    n_dof = 3 * state.positions.shape[-2]
    return 2.0 * kinetic_energy(state, masses) / (n_dof * BOLTZ)


def make_respa_langevin_step(slow_force_fn: Callable,
                             fast_force_fn: Callable, masses, dt_outer,
                             n_inner: int, friction, temperature,
                             constraints=None):
    """Multiple-timestep (r-RESPA) Langevin step.

    Slow forces (grid interactions) kick at ``dt_outer``; fast forces
    (bonded and intramolecular terms) integrate with classic Langevin at
    ``dt_outer / n_inner``. Impulse (Trotter) splitting:

        v += dt/2 * F_slow / m
        n_inner x { classic Langevin step with F_fast at dt/n }
        v += dt/2 * F_slow / m

    The returned step maps ``((MDState, f_slow), noise=None) -> (MDState,
    f_slow)``, ``noise`` None or [n_inner, ..., N, 3]: the closing
    half-kick's slow force is the next step's opening one (same
    positions), so it is carried rather than recomputed. Use
    :func:`run_respa_segment`.
    """
    inv_m = (1.0 / masses)[:, None]
    inner = make_langevin_step(fast_force_fn, masses, dt_outer / n_inner,
                               friction, temperature,
                               constraints=constraints)

    def step(carry, noise=None):
        state, f_slow = carry
        x, v, gen = state
        v = v + 0.5 * dt_outer * f_slow * inv_m
        s = run_segment(inner, MDState(x, v, gen), n_inner, noise=noise)
        f_slow2 = slow_force_fn(s.positions)
        v = s.velocities + 0.5 * dt_outer * f_slow2 * inv_m
        if constraints is not None:
            v, _ = apply_rattle(constraints, s.positions, v)
        return MDState(s.positions, v, s.generator), f_slow2

    step.n_inner = n_inner
    return step


def run_respa_segment(step_fn: Callable, slow_force_fn: Callable,
                      state: MDState, n_outer: int, noise=None) -> MDState:
    """Advance ``n_outer`` r-RESPA outer steps: one slow-force evaluation
    per outer step, plus one to seed the carry. ``noise`` is None or
    [n_outer, n_inner, ..., N, 3]. On the card the outer steps are graph
    replays carrying (positions, velocities, slow force)."""
    _check_noise(noise, n_outer)
    carry = (state, slow_force_fn(state.positions))
    if _recorded(state):
        gen = state.generator

        def advance(c, nz):
            s, f = step_fn((MDState(c[0], c[1], gen), c[2]), nz)
            return s.positions, s.velocities, f

        v = state.velocities
        shape = (tuple(noise.shape[1:]) if noise is not None
                 else (step_fn.n_inner,) + tuple(v.shape))
        seg = graphs.Segment(advance, (state.positions, v, carry[1]),
                             noise_shape=shape)
        x, v, _ = seg.run((state.positions, v, carry[1]), n_outer,
                          noise=noise, generator=gen)
        return MDState(x, v, gen)
    for s in range(n_outer):
        carry = step_fn(carry, None if noise is None else noise[s])
    return carry[0]
