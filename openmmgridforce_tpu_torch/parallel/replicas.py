"""Replica ensembles as a leading [R] dimension of the MD state."""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..mm.integrators import MDState, instantaneous_temperature
from ..units import BOLTZ


def replica_temperatures(states: MDState, masses) -> torch.Tensor:
    """Per-replica instantaneous temperature [R] in K (3N degrees of
    freedom, no constraint correction): a cheap health probe, not a
    thermodynamic estimator."""
    return instantaneous_temperature(states, masses)


def init_replica_states(generator: torch.Generator, positions, masses,
                        temperatures, n_replicas: int,
                        device=None) -> MDState:
    """Batched Maxwell-Boltzmann initialization on ``device``.

    ``positions`` [N, 3] is shared by all replicas; ``temperatures`` may
    be a number or an [R] tensor (replica-exchange ladders). Velocities are
    drawn from ``generator``, which must live on ``device`` and becomes the
    states' noise source.
    """
    device = resolve_device(device)
    x = torch.as_tensor(positions, device=device)
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float64)
    m = torch.as_tensor(masses, dtype=x.dtype, device=device)
    temps = torch.as_tensor(temperatures, dtype=x.dtype, device=device)
    temps = temps.expand(n_replicas)
    sigma_v = torch.sqrt(BOLTZ * temps[:, None] / m)[..., None]  # [R,N,1]
    z = torch.randn((n_replicas,) + tuple(x.shape), generator=generator,
                    dtype=x.dtype, device=device)
    states_x = x.expand(n_replicas, *x.shape).clone()
    return MDState(states_x, sigma_v * z, generator)
