"""System: masses, bonded terms and the intra-ligand pair table, plus the
total energy/force function and the MD segment runner.

All terms act on positions [..., N, 3]; replicas are a leading [R]
dimension.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..grid import Grid
from ..ops.cuda_ligand_forces import ligand_bonded, ligand_pairs
from ..ops.interpolate import evaluate_grid
from ..ops.packed import (HermitePackedGrid, MultiHermitePackedGrid,
                          MultiPackedGrid, PackedGrid,
                          evaluate_hermite_multi, evaluate_hermite_packed,
                          evaluate_multi, evaluate_packed)
from ..ops.pairwise import PairTable, build_pair_table, pair_energy_forces
from ..utils.observe import trace
from . import graphs
from .amber import AmberTopology
from .constraints import ConstraintSet, constraints_from_bonds
from .forcefield import bonded_energy
from .integrators import (MDState, _recorded, langevin_segment,
                          make_langevin_step, run_segment)

# accepted spellings of system_from_amber's ``constraints``
_CONSTRAINT_ALIASES = {"HBonds": "h_bonds", "AllBonds": "all_bonds",
                       "h_bonds": "h_bonds", "all_bonds": "all_bonds"}


@dataclasses.dataclass(frozen=True)
class System:
    masses: torch.Tensor          # [N] amu
    charges: torch.Tensor         # [N] e
    sigmas: torch.Tensor          # [N] nm
    epsilons: torch.Tensor        # [N] kJ/mol
    bond_idx: torch.Tensor        # [B, 2] int64
    bond_k: torch.Tensor
    bond_r0: torch.Tensor
    angle_idx: torch.Tensor       # [A, 3]
    angle_k: torch.Tensor
    angle_t0: torch.Tensor
    torsion_idx: torch.Tensor     # [T, 4]
    torsion_k: torch.Tensor
    torsion_per: torch.Tensor
    torsion_phase: torch.Tensor
    pairs: Optional[PairTable] = None
    constraints: Optional[ConstraintSet] = None

    @property
    def num_atoms(self) -> int:
        return self.masses.shape[0]


def system_from_amber(top: AmberTopology, dtype=torch.float64,
                      hydrogen_mass: Optional[float] = None,
                      include_nonbonded: bool = True,
                      constraints: Optional[str] = None,
                      device=None) -> System:
    """Build a System from a parsed AMBER topology, on ``device``.

    ``hydrogen_mass``: if set, repartition hydrogen masses to this value,
    subtracting the difference from the bonded heavy atom (OpenMM's
    hydrogenMass option).
    ``include_nonbonded``: False leaves out the intra-ligand pair table
    (``pairs`` None: bonded terms only).
    ``constraints``: None, "h_bonds" (alias "HBonds") or "all_bonds"
    (alias "AllBonds"). Constrained bonds leave the harmonic terms (OpenMM's
    createSystem semantics) and become the System's ConstraintSet, whose
    inverse masses are the repartitioned ones.
    """
    device = resolve_device(device)
    masses = np.array(top.masses, dtype=float)
    if hydrogen_mass is not None:
        is_h = masses < 2.0  # hydrogens (and extra points excluded: mass 0)
        is_h &= masses > 0.0
        for (i, j) in top.bond_idx:
            hi, heavy = (i, j) if is_h[i] and not is_h[j] else \
                ((j, i) if is_h[j] and not is_h[i] else (None, None))
            if hi is not None:
                delta = hydrogen_mass - masses[hi]
                masses[hi] += delta
                masses[heavy] -= delta

    pairs = None
    if include_nonbonded:
        exceptions = []
        for p, (i, j) in enumerate(top.pairs14):
            qq = top.charges[i] * top.charges[j] / top.scee[p]
            sg = 0.5 * (top.sigmas[i] + top.sigmas[j])
            ep = np.sqrt(top.epsilons[i] * top.epsilons[j]) / top.scnb[p]
            exceptions.append((int(i), int(j), qq, sg, ep))
        pairs = build_pair_table(top.charges, top.sigmas, top.epsilons,
                                 exclusions=sorted(set(top.exclusions)),
                                 exceptions=exceptions, dtype=dtype,
                                 device=device)

    cset = None
    bond_idx, bond_k, bond_r0 = top.bond_idx, top.bond_k, top.bond_r0
    if constraints is not None:
        cset = constraints_from_bonds(top.bond_idx, top.bond_r0,
                                      top.masses,  # pre-repartition masses
                                      which=_CONSTRAINT_ALIASES[constraints],
                                      dtype=dtype, device=device)
        cset = dataclasses.replace(cset, inv_mass=torch.as_tensor(
            1.0 / masses, dtype=dtype, device=device))
        cidx = {tuple(sorted(p)) for p in cset.idx.tolist()}
        keep = np.array([tuple(sorted(b)) not in cidx
                         for b in np.asarray(top.bond_idx).tolist()],
                        dtype=bool)
        bond_idx = np.asarray(top.bond_idx).reshape(-1, 2)[keep]
        bond_k = np.asarray(top.bond_k)[keep]
        bond_r0 = np.asarray(top.bond_r0)[keep]

    def arr(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)

    def iarr(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    return System(
        masses=arr(masses),
        charges=arr(top.charges),
        sigmas=arr(top.sigmas),
        epsilons=arr(top.epsilons),
        bond_idx=iarr(bond_idx).reshape(-1, 2),
        bond_k=arr(bond_k),
        bond_r0=arr(bond_r0),
        angle_idx=iarr(top.angle_idx).reshape(-1, 3),
        angle_k=arr(top.angle_k),
        angle_t0=arr(top.angle_t0),
        torsion_idx=iarr(top.torsion_idx).reshape(-1, 4),
        torsion_k=arr(top.torsion_k),
        torsion_per=arr(top.torsion_per),
        torsion_phase=arr(top.torsion_phase),
        pairs=pairs,
        constraints=cset,
    )


@dataclasses.dataclass(frozen=True)
class GridBinding:
    """A grid plus the per-atom scaling factors that couple atoms to it:
    [N] for a Grid (reference layout, a gather per stencil point), a
    PackedGrid or a HermitePackedGrid (one row gather per atom), [G, N] for
    the fused MultiPackedGrid and MultiHermitePackedGrid."""

    grid: object
    scaling: torch.Tensor


def _eval_grid(grid, positions, scaling):
    if isinstance(grid, MultiPackedGrid):
        return evaluate_multi(grid, positions, scaling)  # scaling [G, N]
    if isinstance(grid, MultiHermitePackedGrid):
        return evaluate_hermite_multi(grid, positions, scaling)
    if isinstance(grid, PackedGrid):
        return evaluate_packed(grid, positions, scaling)
    if isinstance(grid, HermitePackedGrid):
        return evaluate_hermite_packed(grid, positions, scaling)
    if isinstance(grid, Grid):
        return evaluate_grid(grid, positions, scaling)
    # imported here: the parallel package imports this module's package
    from ..parallel.sharded_grid import ShardedPackedGrid, evaluate_sharded
    if isinstance(grid, ShardedPackedGrid):
        return evaluate_sharded(grid, positions, scaling)
    raise TypeError(f"cannot evaluate a {type(grid).__name__}")


def grid_energy(grids: Sequence[GridBinding], positions):
    """Total grid energy of the bindings (no bonded/pair terms)."""
    e = 0.0
    for gb in grids:
        e = e + _eval_grid(gb.grid, positions, gb.scaling).energy
    return e


def potential_energy(system: System, grids: Sequence[GridBinding],
                     positions):
    """Total potential energy (differentiable with torch.autograd).

    On the card a fused polynomial pack's energy is differentiable in the
    positions only: its kernel (``ops/cuda_packed_eval.py``) raises where
    the scalings or the coefficients require grad, which the host's route
    differentiates."""
    e = bonded_energy(positions, system)
    if system.pairs is not None:
        e = e + pair_energy_forces(system.pairs, positions)[0]
    for gb in grids:
        e = e + _eval_grid(gb.grid, positions, gb.scaling).energy
    return e


def energy_and_forces(system: System, grids: Sequence[GridBinding],
                      positions):
    """Total energy [...] and forces [..., N, 3], all in closed form. A
    sharded table (``parallel/sharded_grid.py``) among the grids makes
    this a collective over its mesh axis. Each term is a span
    (``omgf.force.bonded``, ``.pair``, ``.grid``) that takes in the sum of
    its share into the totals. On the card the bonded terms and the pairs
    are a kernel each (``ops/cuda_ligand_forces.py``; the pair kernel
    makes the sums), on the host their plain twins."""
    with trace("omgf.force.bonded"):
        energy, forces = ligand_bonded(positions, system)
    if system.pairs is not None:
        with trace("omgf.force.pair"):
            energy, forces = ligand_pairs(system.pairs, positions, energy,
                                          forces)
    for gb in grids:
        with trace("omgf.force.grid"):
            res = _eval_grid(gb.grid, positions, gb.scaling)
            energy = energy + res.energy
            forces = forces + res.forces
    return energy, forces


# recorded segments of make_md_runner on the card, by what they were
# recorded for; the oldest is dropped beyond _SEGMENT_CACHE
_SEGMENTS = collections.OrderedDict()
_SEGMENT_CACHE = 8


class _MDSegment:
    """A recorded Langevin segment of one system and set of grids: the
    temperature buffer the steps read and the segment's blocks. Holds the
    system and grids, so that no other object takes their identities."""

    def __init__(self, system, grids, states, dt, friction, scheme,
                 batched):
        x = states.positions
        shape = (x.shape[0], 1, 1) if batched else ()
        grids = self.grids = list(grids)
        self.system = system
        self.temperature = torch.zeros(shape, dtype=x.dtype,
                                       device=x.device)

        def force_fn(pos):
            return energy_and_forces(system, grids, pos)[1]

        step = make_langevin_step(force_fn, system.masses, dt, friction,
                                  self.temperature, scheme=scheme,
                                  constraints=system.constraints)
        self.segment = langevin_segment(step, states)


def _md_segment(system, grids, states, dt, friction, scheme, batched):
    x = states.positions
    key = (id(system), tuple((id(gb.grid), id(gb.scaling)) for gb in grids),
           tuple(x.shape), x.dtype, x.device, scheme, dt, friction, batched)
    seg = _SEGMENTS.pop(key, None)
    if seg is None:
        seg = _MDSegment(system, grids, states, dt, friction, scheme,
                         batched)
    _SEGMENTS[key] = seg
    while len(_SEGMENTS) > _SEGMENT_CACHE:
        _SEGMENTS.popitem(last=False)
    return seg


def make_md_runner(n_steps: int, dt: float, friction: float,
                   scheme: str = "classic", device=None,
                   batched: bool = True):
    """Build a Langevin segment runner for states on ``device``.

    Returns ``run(states, system, grids, temperatures, noise=None)``.
    ``batched`` True: ``states`` are [R, N, 3] and ``temperatures`` a
    number or [R] (replica ladders); False: one state [N, 3] and one
    temperature. ``noise`` None (drawn from the states' generator) or
    [n_steps, *states.shape]. ``scheme`` is "classic" or "middle"; the
    system's constraints, if any, apply after every position update.

    On the card the segment replays CUDA graphs of blocks of steps
    (``mm/graphs.py``), recorded once per system, grids, state shape,
    dtype, device, scheme, dt, friction and block length and kept in a
    bounded cache, so the runners of one system share their recordings;
    the temperatures are copied into the recording's buffer before the
    replays. A sharded table whose all-reduce goes through the host
    (gloo over more than one rank) cannot be recorded: its segments run
    their blocks as eager launches (``graphs.eager()``). On the CPU it is
    the plain loop of steps. Each call is the span ``omgf.segment``.
    """
    device = resolve_device(device)

    def run(states, system, grids, temperatures, noise=None):
        with trace("omgf.segment"):
            return _run(states, system, grids, temperatures, noise)

    def _run(states, system, grids, temperatures, noise):
        x = states.positions
        if x.device != device:
            raise ValueError(f"states are on {x.device}, the runner on "
                             f"{device}")
        if x.dim() != (3 if batched else 2):
            raise ValueError(f"states of shape {tuple(x.shape)}; the runner "
                             f"takes {'[R, N, 3]' if batched else '[N, 3]'}")
        t = torch.as_tensor(temperatures, dtype=x.dtype, device=device)
        t = t.expand(x.shape[0])[:, None, None] if batched else t.reshape(())
        if _recorded(states):
            seg = _md_segment(system, grids, states, dt, friction, scheme,
                              batched)
            seg.temperature.copy_(t)
            recordable = all(getattr(gb.grid, "recordable", True)
                             for gb in grids)
            with (contextlib.nullcontext() if recordable
                  else graphs.eager()):
                xo, vo = seg.segment.run((x, states.velocities), n_steps,
                                         noise=noise,
                                         generator=states.generator)
            return MDState(xo, vo, states.generator)

        def force_fn(pos):
            return energy_and_forces(system, grids, pos)[1]

        step = make_langevin_step(force_fn, system.masses, dt, friction, t,
                                  scheme=scheme,
                                  constraints=system.constraints)
        return run_segment(step, states, n_steps, noise=noise)

    return run
