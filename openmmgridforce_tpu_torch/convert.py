"""Build the port's objects from plain arrays of the JAX package's state.

Each function takes numpy arrays (``np.asarray`` of the JAX leaves) plus
the static fields, and returns the port's object on ``device``. JAX PRNG
keys are not carried over: a state gets a fresh ``torch.Generator``
seeded with ``seed``.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .grid import Grid, InterpolationMethod
from .mm.constraints import ConstraintSet
from .mm.integrators import MDState
from .mm.system import System
from .ops.packed import (HermitePackedGrid, MultiHermitePackedGrid,
                         MultiPackedGrid, PackedGrid)
from .ops.pairwise import PairTable

SYSTEM_FIELDS = ("masses", "charges", "sigmas", "epsilons", "bond_idx",
                 "bond_k", "bond_r0", "angle_idx", "angle_k", "angle_t0",
                 "torsion_idx", "torsion_k", "torsion_per", "torsion_phase")
_INDEX_FIELDS = {"bond_idx": 2, "angle_idx": 3, "torsion_idx": 4}
PAIR_FIELDS = ("qq", "sigma", "epsilon", "mask")
CONSTRAINT_FIELDS = ("idx", "length", "inv_mass")


def _float(x, dtype, device):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def constraints_from_arrays(idx, length, inv_mass, *, dtype=torch.float64,
                            device=None) -> ConstraintSet:
    """The port's ConstraintSet from the arrays of a JAX ConstraintSet."""
    device = resolve_device(device)
    return ConstraintSet(
        idx=torch.as_tensor(np.asarray(idx, np.int64),
                            device=device).reshape(-1, 2),
        length=_float(length, dtype, device),
        inv_mass=_float(inv_mass, dtype, device))


def system_from_arrays(arrays, pairs=None, constraints=None, *,
                       dtype=torch.float64, device=None) -> System:
    """``arrays``: mapping of every name in SYSTEM_FIELDS to an array;
    ``pairs``: None or a mapping of PAIR_FIELDS; ``constraints``: None or
    a mapping of CONSTRAINT_FIELDS."""
    device = resolve_device(device)
    fields = {}
    for name in SYSTEM_FIELDS:
        if name in _INDEX_FIELDS:
            fields[name] = torch.as_tensor(
                np.asarray(arrays[name], np.int64), device=device
            ).reshape(-1, _INDEX_FIELDS[name])
        else:
            fields[name] = _float(arrays[name], dtype, device)
    table = None
    if pairs is not None:
        table = PairTable(**{k: _float(pairs[k], dtype, device)
                             for k in PAIR_FIELDS})
    cset = None
    if constraints is not None:
        cset = constraints_from_arrays(
            *(constraints[k] for k in CONSTRAINT_FIELDS), dtype=dtype,
            device=device)
    return System(pairs=table, constraints=cset, **fields)


def grid_from_arrays(vals, spacing, origin, *, interp_method=0,
                     inv_power_mode=0, inv_power=0.0, grid_cap=41840.0,
                     oob_k=10000.0, grid_type="", derivs=None,
                     dtype=torch.float64, device=None) -> Grid:
    """``derivs``: None or [nx, ny, nz, 27], the JAX Grid's own layout."""
    device = resolve_device(device)
    vals = _float(vals, dtype, device)
    if derivs is not None:
        derivs = _float(derivs, dtype, device)
        if derivs.shape != vals.shape + (27,):
            raise ValueError(f"derivs shape {tuple(derivs.shape)} does not "
                             f"match grid {tuple(vals.shape)} (+27)")
    return Grid(vals=vals, derivs=derivs,
                spacing=_float(spacing, dtype, device),
                origin=_float(origin, dtype, device),
                counts=tuple(int(c) for c in vals.shape),
                interp_method=int(interp_method),
                inv_power_mode=int(inv_power_mode),
                inv_power=float(inv_power), grid_cap=float(grid_cap),
                oob_k=float(oob_k), grid_type=grid_type)


def packed_from_arrays(coeffs, spacing, origin, *, counts, degree,
                       back_power=0.0, oob_k=0.0, poly_basis="monomial",
                       dtype=torch.float64, device=None) -> PackedGrid:
    device = resolve_device(device)
    return PackedGrid(coeffs=_float(coeffs, dtype, device).contiguous(),
                      spacing=_float(spacing, dtype, device),
                      origin=_float(origin, dtype, device),
                      counts=tuple(int(c) for c in counts),
                      degree=int(degree), back_power=float(back_power),
                      oob_k=float(oob_k), poly_basis=poly_basis)


def multi_packed_from_arrays(coeffs, spacing, origin, *, counts, degree,
                             n_grids, back_powers, oob_k=0.0,
                             poly_basis="monomial", dtype=torch.float64,
                             device=None) -> MultiPackedGrid:
    """Accepts the JAX package's lane-padded fused table and keeps its
    first G*K columns."""
    device = resolve_device(device)
    width = int(n_grids) * int(degree) ** 3
    coeffs = np.asarray(coeffs)[:, :width]
    return MultiPackedGrid(
        coeffs=_float(coeffs, dtype, device).contiguous(),
        spacing=_float(spacing, dtype, device),
        origin=_float(origin, dtype, device),
        counts=tuple(int(c) for c in counts), degree=int(degree),
        n_grids=int(n_grids),
        back_powers=tuple(float(b) for b in back_powers),
        oob_k=float(oob_k), poly_basis=poly_basis)


def hermite_packed_from_arrays(coeffs, spacing, origin, *, counts, method,
                               back_power=0.0, oob_k=0.0,
                               dtype=torch.float64,
                               device=None) -> HermitePackedGrid:
    device = resolve_device(device)
    return HermitePackedGrid(
        coeffs=_float(coeffs, dtype, device).contiguous(),
        spacing=_float(spacing, dtype, device),
        origin=_float(origin, dtype, device),
        counts=tuple(int(c) for c in counts), method=int(method),
        back_power=float(back_power), oob_k=float(oob_k))


def multi_hermite_packed_from_arrays(coeffs, spacing, origin, *, counts,
                                     method, n_grids, back_powers,
                                     oob_k=0.0, dtype=torch.float64,
                                     device=None) -> MultiHermitePackedGrid:
    """Accepts the JAX package's lane-padded fused table and keeps its
    first G*8*D columns."""
    device = resolve_device(device)
    slots = 8 if int(method) == InterpolationMethod.TRICUBIC else 27
    coeffs = np.asarray(coeffs)[:, :int(n_grids) * 8 * slots]
    return MultiHermitePackedGrid(
        coeffs=_float(coeffs, dtype, device).contiguous(),
        spacing=_float(spacing, dtype, device),
        origin=_float(origin, dtype, device),
        counts=tuple(int(c) for c in counts), method=int(method),
        n_grids=int(n_grids),
        back_powers=tuple(float(b) for b in back_powers),
        oob_k=float(oob_k))


def sharded_packed_from_arrays(coeffs, spacing, origin, *, counts, degree,
                               n_grids, back_powers, oob_k, ncx_padded,
                               form, method, poly_basis, mesh,
                               axis="sp", dtype=torch.float64):
    """This rank's rows of a JAX ShardedPackedGrid: ``coeffs`` is the JAX
    package's global (lane-padded) table [ncx_padded * ncy * ncz, width],
    the other arguments its static fields. Returns the port's
    ShardedPackedGrid on the mesh's device, as ``shard_packed_grid`` lays
    it out."""
    from .parallel.sharded_grid import ShardedPackedGrid

    slots = 8 if int(method) == InterpolationMethod.TRICUBIC else 27
    K = 8 * slots if form == "hermite" else int(degree) ** 3
    n, i = mesh.size(axis), mesh.index(axis)
    rows = (int(ncx_padded) // n) * (int(counts[1]) - 1) * (int(counts[2]) - 1)
    coeffs = np.asarray(coeffs)[i * rows:(i + 1) * rows, :int(n_grids) * K]
    return ShardedPackedGrid(
        coeffs=_float(coeffs, dtype, mesh.device).contiguous(),
        spacing=_float(spacing, dtype, mesh.device),
        origin=_float(origin, dtype, mesh.device),
        counts=tuple(int(c) for c in counts), degree=int(degree),
        n_grids=int(n_grids),
        back_powers=tuple(float(b) for b in back_powers),
        oob_k=float(oob_k), ncx_padded=int(ncx_padded), form=form,
        method=int(method), poly_basis=poly_basis, mesh=mesh, axis=axis)


def states_from_arrays(positions, velocities, *, seed: int,
                       dtype=torch.float64, device=None) -> MDState:
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return MDState(_float(positions, dtype, device),
                   _float(velocities, dtype, device), gen)


def grid_from_jax(vals, spacing, origin, *, derivs=None, device=None,
                  **fields) -> Grid:
    """The port's Grid from the arrays of a JAX Grid as read from a file
    (``io.grid_from_file``), keeping their dtype; ``fields`` are the static
    fields (``interp_method``, ``grid_cap`` ...)."""
    from .grid import grid_from_numpy

    return grid_from_numpy(np.asarray(vals), np.asarray(spacing),
                           np.asarray(origin),
                           derivs=None if derivs is None
                           else np.asarray(derivs),
                           device=device, **fields)


STREAM_SET_ARRAYS = ("_starts", "_full", "_calm")
STREAM_SET_COUNTERS = ("packs_built", "direct_builds", "full_escalations")


def stream_set_bookkeeping(stream_set) -> dict:
    """The region bookkeeping of a StreamSet of either package as numpy
    arrays (absent ones as empty arrays), so that two can be compared:
    the per-replica starts, full-grid flags and calm counts, and the
    build and escalation counters."""
    out = {}
    for name in STREAM_SET_ARRAYS:
        value = getattr(stream_set, name)
        out[name] = np.zeros(0) if value is None else np.asarray(value)
    for name in STREAM_SET_COUNTERS:
        out[name] = np.asarray(getattr(stream_set, name))
    return out
