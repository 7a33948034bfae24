"""Classic Langevin integration over a written-out replica dimension.

The classic scheme matches OpenMM's ``LangevinIntegrator``:

    a = exp(-gamma dt)
    v <- a v + (1 - a) f / (m gamma) + sqrt(kT (1 - a^2) / m) xi
    x <- x + v dt

A segment is a Python loop of steps. States are [..., N, 3] (replicas are
[R, N, 3]); the Gaussian noise xi comes from the state's explicit
``torch.Generator``, or from a ``noise`` tensor the caller passes (the
tests feed both packages the same numbers this way). The middle scheme,
Verlet, constraints and RESPA are not ported yet (ROADMAP, Queue A).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..units import BOLTZ


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


def make_langevin_step(force_fn: Callable, masses, dt, friction,
                       temperature):
    """Build one classic Langevin step ``step(state, noise=None) -> state``.

    force_fn(positions) -> forces [..., N, 3] (kJ/mol/nm). masses [N] amu,
    dt ps, friction 1/ps, temperature K: a number, or a tensor that
    broadcasts against [..., N, 1] (per-replica temperatures are [R, 1, 1]).
    """
    inv_m = (1.0 / masses)[:, None]
    a = torch.exp(torch.tensor(-friction * dt, dtype=masses.dtype,
                               device=masses.device))
    kT = BOLTZ * temperature
    # friction == 0 would make the classic force term 0/0; use the
    # ballistic limit (1-a)/gamma -> dt. The friction != 0 expression
    # keeps the reference's operation order: a one-ulp reorder sends f32
    # trajectories elsewhere.
    zero_friction = friction == 0.0

    def step(state: MDState, noise=None) -> MDState:
        x, v, gen = state
        f = force_fn(x)
        if noise is None:
            noise = torch.randn(v.shape, generator=gen, dtype=v.dtype,
                                device=v.device)
        kick = (dt * f * inv_m if zero_friction
                else (1.0 - a) * f * inv_m / friction)
        v = (a * v + kick
             + torch.sqrt(kT * (1.0 - a * a) * inv_m) * noise)
        x_new = x + v * dt
        return MDState(x_new, v, gen)

    return step


def run_segment(step_fn: Callable, state: MDState, n_steps: int,
                noise=None) -> MDState:
    """Run ``n_steps`` steps; ``noise`` is None or [n_steps, ..., N, 3]."""
    if noise is not None and noise.shape[0] != n_steps:
        raise ValueError(f"noise has {noise.shape[0]} steps, not {n_steps}")
    for s in range(n_steps):
        state = step_fn(state, None if noise is None else noise[s])
    return state


def kinetic_energy(state: MDState, masses):
    m = masses[:, None]
    return 0.5 * (m * state.velocities ** 2).sum((-2, -1))


def instantaneous_temperature(state: MDState, masses):
    n_dof = 3 * state.positions.shape[-2]
    return 2.0 * kinetic_energy(state, masses) / (n_dof * BOLTZ)
