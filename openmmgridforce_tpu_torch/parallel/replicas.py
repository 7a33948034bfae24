"""Replica ensembles as a leading [R] dimension of the MD state, and
their split over the ``dp`` axis of a :class:`~.mesh.Mesh`.

Under a mesh each rank holds the rows ``replica_rows(mesh, R)`` of the
ensemble. Noise that must not depend on the layout is drawn whole on
every rank from one identically seeded generator, and each rank keeps its
rows (``replica_noise``); the JAX package gets the same from per-replica
threefry keys.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..mm import graphs
from ..mm.integrators import (MDState, _recorded, instantaneous_temperature,
                              run_segment)
from ..units import BOLTZ
from .mesh import Mesh


def replica_mesh(device, axis_name: str = "dp") -> Mesh:
    """1-D mesh of every rank of the default process group (rank order),
    this rank on ``device``."""
    import torch.distributed as dist

    return Mesh((dist.get_world_size(),), (axis_name,), device)


def replica_rows(mesh: Mesh, n_global: int, axis_name: str = "dp") -> slice:
    """The global rows [lo, hi) of ``n_global`` replicas that this rank
    holds; ``n_global`` must divide by the axis size."""
    n = mesh.size(axis_name)
    if n_global % n:
        raise ValueError(f"{n_global} replicas do not divide over the "
                         f"'{axis_name}' axis of size {n}")
    per = n_global // n
    lo = mesh.index(axis_name) * per
    return slice(lo, lo + per)


def shard_replica_states(mesh: Mesh, state: MDState,
                         axis_name: str = "dp") -> MDState:
    """This rank's rows ``replica_rows(mesh, R, axis_name)`` of a batched
    MDState of R replicas, on the mesh's device; the generator is kept
    (every rank holds an identically seeded one)."""
    rows = replica_rows(mesh, state.positions.shape[0], axis_name)
    return MDState(state.positions[rows].to(mesh.device).clone(),
                   state.velocities[rows].to(mesh.device).clone(),
                   state.generator)


def replica_noise(generator, n_steps: int, shape, dtype, mesh: Mesh,
                  axis_name: str = "dp", blocks: bool = False):
    """This rank's rows [n_steps, *shape] of the ensemble's Langevin noise:
    the global [R, N, 3] normals of every step (``blocks``: of every block
    of ``graphs.BLOCK`` steps at once, as a recorded one-rank segment draws
    them) from ``generator``, on its device, rows ``replica_rows`` kept.
    ``shape`` is this rank's [R_local, N, 3]."""
    full = (shape[0] * mesh.size(axis_name),) + tuple(shape[1:])
    rows = replica_rows(mesh, full[0], axis_name)
    step = graphs.BLOCK if blocks else 1
    out = torch.empty((n_steps,) + tuple(shape), dtype=dtype,
                      device=generator.device)
    for s in range(0, n_steps, step):
        k = min(step, n_steps - s)
        draw = torch.empty((k,) + full, dtype=dtype, device=generator.device)
        out[s:s + k] = draw.normal_(generator=generator)[:, rows]
    return out


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


def make_ensemble_runner(step_fn, n_steps: int, mesh: Mesh = None,
                         axis_name: str = "dp"):
    """``run(states) -> states`` advancing a batched MDState by ``n_steps``
    of ``step_fn`` (which takes the step's noise, as a Langevin step
    does). With a mesh, ``states`` are this rank's rows of the ensemble:
    pure data parallel, no collectives (each rank's segment recorded on
    the card as ``run_segment``'s), the noise of the whole ensemble drawn
    from the states' generator (seeded alike on every rank) by
    ``replica_noise``, so the run does not depend on the layout."""
    def run(states: MDState) -> MDState:
        if mesh is None:
            return run_segment(step_fn, states, n_steps)
        x = states.positions
        if x.device != mesh.device:
            raise ValueError(f"states are on {x.device}, the mesh's rank "
                             f"on {mesh.device}")
        noise = replica_noise(states.generator, n_steps, x.shape, x.dtype,
                              mesh, axis_name, blocks=_recorded(states))
        return run_segment(step_fn, states, n_steps, noise=noise)

    return run
