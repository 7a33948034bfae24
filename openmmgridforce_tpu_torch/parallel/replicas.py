"""Replica ensembles as a leading [R] dimension of the MD state.

The JAX package's replica mesh (``replica_mesh``, ``shard_replica_states``,
``make_ensemble_runner``) is not ported yet (ROADMAP Queue A item 15).
"""

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


def redraw_hot_velocities(states: MDState, masses, temperatures, threshold):
    """Re-thermalize fusion-trapped replicas; leave the rest untouched.

    ``threshold`` is in K: a number, or [R] for per-replica thresholds
    (temperature ladders scale it with the rung temperature). Replicas
    whose instantaneous temperature exceeds it get fresh Maxwell-Boltzmann
    velocities at their target temperature (a number or [R]); every other
    replica keeps bitwise-identical velocities and positions.

    The JAX package draws each hot replica from that replica's own key;
    here the states share one ``torch.Generator``, which draws a full
    [R, N, 3] batch on every call, so which numbers a hot replica gets
    differs from JAX's while the contract above holds. Returns
    ``(new_states, n_redrawn)``.
    """
    t_inst = replica_temperatures(states, masses)
    hot = t_inst > torch.as_tensor(threshold, dtype=t_inst.dtype,
                                   device=t_inst.device)
    v = states.velocities
    m = torch.as_tensor(masses, dtype=v.dtype, device=v.device)
    temps = torch.as_tensor(temperatures, dtype=v.dtype,
                            device=v.device).expand(t_inst.shape)
    sigma_v = torch.sqrt(BOLTZ * temps[:, None] / m)[..., None]   # [R,N,1]
    fresh = sigma_v * torch.randn(v.shape, generator=states.generator,
                                  dtype=v.dtype, device=v.device)
    v = torch.where(hot[:, None, None], fresh, v)
    return MDState(states.positions, v, states.generator), int(hot.sum())
