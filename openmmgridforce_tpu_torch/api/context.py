"""Context / Simulation / integrator shells over the functional core.

The port of the JAX package's ``api/context.py``. The reference delegated
its runtime to OpenMM (System, Context, integrators, force groups); this
module supplies a minimal equivalent with the same user-facing shapes:

    system = create_system(prmtop_path)   # AmberPrmtopFile.createSystem
    system.addForce(grid_force)           # System.addForce
    ctx = Context(system, LangevinIntegrator(300, 1, 0.002))
    ctx.setPositions(x)
    state = ctx.getState(getEnergy=True, groups={0})
    state.getPotentialEnergy()
    ctx.getIntegrator().step(100)

Everything runs on the CUDA card unless the caller passes ``device="cpu"``
(``create_system``, ``Context``, ``Simulation``); the ``Platform`` name
picks the evaluation semantics, not a device. The Context works in
float64, as the JAX package's does. Forces are resolved at Context
creation into a frozen :class:`_Terms` (grids on the device, atom
selections, scalings); auto-generated grids come from the hand-written
generation kernels (``ops/cuda_gridgen.py``, ``ops/cuda_gridgen_derivs.py``)
in float64. On the card, stepping replays CUDA graphs of blocks of steps
(``mm/graphs.py``), recorded at the first step and dropped whenever the
forces are re-resolved; on the CPU it is the plain loop of steps. Grid
forces are summed onto the atoms in a fixed order (``ops/scatter.py``), so
a recorded step equals the eager one. Minimisation is ``api/lbfgs.py``'s
port of optax's L-BFGS, a host loop over device vectors.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..mm import graphs
from ..mm.amber import load_prmtop
from ..mm.forcefield import (angle_energy_forces, bond_energy_forces,
                             torsion_energy_forces)
from ..mm.integrators import (MDState, make_langevin_step, make_verlet_step,
                              run_segment)
from ..mm.system import system_from_amber
from ..ops.gridgen import auto_scaling_factors, generate_grid
from ..ops.interpolate import evaluate_grid
from ..ops.pairwise import pair_energy_forces
from ..ops.scatter import row_sum, row_sum_plan
from ..units import BOLTZ
from . import lbfgs
from .gridforce import ContextRef, Force, GridForce
from .isolated import IsolatedNonbondedForce


# ----------------------------------------------------------------------
# Internal force wrappers (so `for f in system.getForces(): f.setForceGroup`
# works like it does with OpenMM systems)
# ----------------------------------------------------------------------

class HarmonicBondForce(Force):
    pass


class HarmonicAngleForce(Force):
    pass


class PeriodicTorsionForce(Force):
    pass


class NonbondedForce(Force):
    """Intra-system nonbonded (dense pair table) + per-atom parameters."""

    def __init__(self, charges, sigmas, epsilons):
        super().__init__()
        self.charges = np.asarray(charges)
        self.sigmas = np.asarray(sigmas)
        self.epsilons = np.asarray(epsilons)

    def getNumParticles(self):
        return len(self.charges)

    def getParticleParameters(self, i):
        return (self.charges[i], self.sigmas[i], self.epsilons[i])


class ApiSystem:
    """Holds topology-derived terms plus user-added forces. The terms are
    built in float64 on ``device`` (the CUDA card unless
    ``device="cpu"``); a Context of the system runs there too."""

    def __init__(self, topology, hydrogen_mass: Optional[float] = None,
                 constraints: Optional[str] = None,
                 remove_cm_motion: bool = True, device=None):
        self.topology = topology
        self.constraints = constraints
        self.device = resolve_device(device)
        self._core = system_from_amber(
            topology, dtype=torch.float64, hydrogen_mass=hydrogen_mass,
            constraints=constraints, device=self.device)
        self._forces: List[Force] = [
            HarmonicBondForce(),
            HarmonicAngleForce(),
            PeriodicTorsionForce(),
            NonbondedForce(topology.charges, topology.sigmas,
                           topology.epsilons),
        ]

    def getNumParticles(self):
        return self.topology.natom

    def getParticleMass(self, i):
        return float(self._core.masses[i])

    def addForce(self, force: Force):
        self._forces.append(force)
        return len(self._forces) - 1

    def getForces(self):
        return list(self._forces)

    def getNumForces(self):
        return len(self._forces)

    def getForce(self, index):
        return self._forces[index]

    def removeForce(self, index):
        del self._forces[index]


def create_system(prmtop, hydrogen_mass=None, constraints=None,
                  nonbonded_method="NoCutoff", device=None) -> ApiSystem:
    """Mirror of ``AmberPrmtopFile.createSystem(nonbondedMethod=NoCutoff)``.

    ``prmtop`` may be a path or a parsed AmberTopology. The system's terms
    live on ``device``, the CUDA card unless ``device="cpu"``."""
    if nonbonded_method not in ("NoCutoff",):
        raise NotImplementedError(
            "only NoCutoff is supported (matching the reference workflows)")
    device = resolve_device(device)
    top = (load_prmtop(prmtop) if isinstance(prmtop, (str, os.PathLike))
           else prmtop)
    return ApiSystem(top, hydrogen_mass=hydrogen_mass,
                     constraints=constraints, device=device)


# ----------------------------------------------------------------------
# Integrators
# ----------------------------------------------------------------------

class _Integrator:
    _context = ContextRef()     # the Context it steps

    def __init__(self, dt):
        self.dt = float(dt)

    def getStepSize(self):
        return self.dt

    def step(self, n):
        ctx = self._context
        if ctx is None:
            raise RuntimeError("this integrator is bound to no live Context "
                               "(a Context holds its integrator, not the "
                               "other way round: keep the Context)")
        ctx._step(int(n))


class VerletIntegrator(_Integrator):
    kind = "verlet"


class LangevinIntegrator(_Integrator):
    """Langevin dynamics. The steps read the temperature from a tensor the
    Context fills before every ``step``, so ``setTemperature`` takes
    effect without re-recording anything."""

    kind = "langevin"
    scheme = "classic"

    def __init__(self, temperature, friction, dt):
        super().__init__(dt)
        self.temperature = float(temperature)
        self.friction = float(friction)

    def getTemperature(self):
        return self.temperature

    def setTemperature(self, t):
        self.temperature = float(t)

    def getFriction(self):
        return self.friction


class LangevinMiddleIntegrator(LangevinIntegrator):
    scheme = "middle"


# ----------------------------------------------------------------------
# State
# ----------------------------------------------------------------------

class State:
    def __init__(self, positions=None, velocities=None, energy=None,
                 forces=None, kinetic=None):
        self._positions = positions
        self._velocities = velocities
        self._energy = energy
        self._forces = forces
        self._kinetic = kinetic

    def getPositions(self, asNumpy=True):
        return self._positions

    def getVelocities(self, asNumpy=True):
        return self._velocities

    def getPotentialEnergy(self):
        return self._energy

    def getKineticEnergy(self):
        return self._kinetic

    def getForces(self, asNumpy=True):
        return self._forces


# ----------------------------------------------------------------------
# Resolved forces
# ----------------------------------------------------------------------

class _GridBindingInfo:
    """Resolved evaluation plan for one GridForce, on the device: its grid
    (None when streamed), the atoms it acts on, their scaling factors, and
    the fixed-order row sum that puts its forces on the rows ``target``."""

    def __init__(self, grid, atom_indices, scaling, group_sizes, target,
                 n_atoms, streamer=None):
        self.grid = grid
        self.streamer = streamer
        self.atom_indices = atom_indices
        self.scaling = scaling
        self.group_sizes = group_sizes  # list[int], empty if no groups
        self.target = target
        self.plan = row_sum_plan(target, n_atoms, (target,),
                                 dtype=torch.float64)


class _Terms:
    """Every force of a Context, resolved: the energy and forces of
    positions [..., N, 3] per force and summed over force groups. Step and
    minimiser functions hold this object, not the Context, so a dropped
    recording or streamed engine frees what it read at once."""

    def __init__(self, system, core, semantics, grid_infos, iso_infos):
        self.forces = system.getForces()
        self.core = core
        self.semantics = semantics
        self.grid_infos = grid_infos
        self.iso_infos = iso_infos
        # double-float32 packs (Platform("Compensated")), built at first use
        self.comp_packs: Dict[int, object] = {}
        self.streamed = frozenset(i for i, info in grid_infos.items()
                                  if info.streamer is not None)

    def compensated_pack(self, idx):
        """The (hi|lo) double-float32 pack of in-memory GridForce ``idx``,
        built once. The force's own float64 origin/spacing are passed as
        exact-geometry overrides (see ops/compensated.py)."""
        cp = self.comp_packs.get(idx)
        if cp is None:
            from ..ops.compensated import pack_grid_compensated
            force = self.forces[idx]
            _, spacing, _, _ = force.getGridParameters()
            kw = {}
            if len(spacing) == 3:
                kw = dict(origin=np.asarray(force.getGridOrigin(),
                                            np.float64),
                          spacing=np.asarray(spacing, np.float64))
            cp = pack_grid_compensated(self.grid_infos[idx].grid, **kw)
            self.comp_packs[idx] = cp
        return cp

    def _grid_term(self, idx, x):
        info = self.grid_infos[idx]
        xi = x[..., info.atom_indices, :]
        if info.streamer is not None:
            res = info.streamer.evaluate(xi, info.scaling)
        elif self.semantics == "reference":
            from ..ops.reference_semantics import evaluate_grid_reference
            res = evaluate_grid_reference(info.grid, xi, info.scaling)
        elif self.semantics == "common":
            from ..ops.common_semantics import evaluate_grid_common
            res = evaluate_grid_common(info.grid, xi, info.scaling)
        elif self.semantics == "compensated":
            from ..ops.compensated import evaluate_compensated
            res = evaluate_compensated(self.compensated_pack(idx), xi,
                                       info.scaling)
        else:
            res = evaluate_grid(info.grid, xi, info.scaling)
        return (res.energy.to(x.dtype),
                row_sum(info.plan, res.forces.to(x.dtype)))

    def force_terms(self, idx, x):
        """(energy [...], forces [..., N, 3]) of force ``idx``."""
        force, core = self.forces[idx], self.core
        if isinstance(force, HarmonicBondForce):
            return bond_energy_forces(x, core.bond_idx, core.bond_k,
                                      core.bond_r0)
        if isinstance(force, HarmonicAngleForce):
            return angle_energy_forces(x, core.angle_idx, core.angle_k,
                                       core.angle_t0)
        if isinstance(force, PeriodicTorsionForce):
            return torsion_energy_forces(x, core.torsion_idx, core.torsion_k,
                                         core.torsion_per,
                                         core.torsion_phase)
        if isinstance(force, NonbondedForce):
            return pair_energy_forces(core.pairs, x)
        if isinstance(force, GridForce):
            return self._grid_term(idx, x)
        if isinstance(force, IsolatedNonbondedForce):
            table, particles, plan = self.iso_infos[idx]
            e, fp = pair_energy_forces(table, x[..., particles, :])
            return e, row_sum(plan, fp)
        raise TypeError(f"unknown force type {type(force)}")

    def terms(self, x, groups=None, exclude=()):
        """Energy [...] and forces [..., N, 3] of the forces in ``groups``
        (None: all), leaving out the force indices ``exclude``."""
        energy = x.new_zeros(x.shape[:-2])
        forces = torch.zeros_like(x)
        for idx, force in enumerate(self.forces):
            if idx in exclude:
                continue
            if groups is not None and force.getForceGroup() not in groups:
                continue
            e, f = self.force_terms(idx, x)
            energy = energy + e
            forces = forces + f
        return energy, forces

    def value_and_grad(self, x):
        """The minimisers' objective: total energy and its gradient."""
        e, f = self.terms(x)
        return e, -f


# ----------------------------------------------------------------------
# Context
# ----------------------------------------------------------------------

class Platform:
    """Mirror of openmm.Platform: the name picks the evaluation semantics,
    not a device. ``Reference`` selects the reference platform's
    semantics (quirks Q1-Q5, Q12 — see ops/reference_semantics.py);
    ``Common``/``OpenCL`` the portable kernel's (quirk Q6 scaled OOB
    restraint force, bare-pow inverse power, trilinear/B-spline only — see
    ops/common_semantics.py); ``Compensated`` (alias ``Accurate``)
    evaluates in-memory GridForces through the double-float32 accuracy
    tier (ops/compensated.py), tiled/streamed GridForces keeping the plain
    streamed path. Anything else (or None) selects the engine's default
    CUDA-convention evaluation."""

    def __init__(self, name):
        self._name = name

    def getName(self):
        return self._name

    @staticmethod
    def getPlatformByName(name):
        return Platform(name)


def _semantics(platform):
    name = str(platform.getName() if hasattr(platform, "getName")
               else platform).lower()
    return ("reference" if name == "reference"
            else "common" if name in ("common", "opencl")
            else "compensated" if name in ("compensated", "accurate")
            else "cuda")


class Context:
    def __init__(self, system: ApiSystem, integrator: _Integrator,
                 platform=None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.system = system
        if self.device != system.device:
            raise ValueError(
                f"a Context on {self.device} for a system built on "
                f"{system.device}: pass create_system the same device")
        self.integrator = integrator
        integrator._context = self
        self._semantics = _semantics(platform)
        self._core = system._core
        self._positions: Optional[torch.Tensor] = None
        self._velocities: Optional[torch.Tensor] = None
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))
        # the temperature the Langevin steps read, filled before each run
        self._temperature = torch.zeros((), dtype=torch.float64,
                                        device=self.device)
        self._segment = None        # recorded in-memory stepping
        # streamed grids: host-side region refresh cadence during stepping
        # (the reference re-prepares tiles EVERY step,
        # CudaGridForceKernels.cpp:888-975; here the region carries enough
        # margin that one refresh serves a whole segment). Stepping
        # DELEGATES to mm.StreamedBatchMD (a Context is a batch of one
        # replica), so both paths share its running-bbox exactness.
        self.stream_refresh_steps = 50
        # cap on the full-grid escalation payload for streamed MD (see
        # mm.streamed_md.StreamSet); 0 disables escalation — a cloud
        # that outruns every bounded region then raises instead
        self.stream_full_region_budget_bytes = 4 << 30
        self._stream_engine = None
        self._initialize_forces()

    # --- force resolution (the reference's kernel initialize() path) ----
    def _initialize_forces(self):
        n = self.system.getNumParticles()
        top = self.system.topology
        grid_infos, iso_infos = {}, {}
        for idx, force in enumerate(self.system.getForces()):
            if isinstance(force, GridForce):
                grid_infos[idx] = self._resolve_grid_force(force, n, top)
                force._context = self
            elif isinstance(force, IsolatedNonbondedForce):
                table, particles = force._build(device=self.device)
                iso_infos[idx] = (table, particles, row_sum_plan(
                    particles, n, (particles,), dtype=torch.float64))
        self._terms = _Terms(self.system, self._core, self._semantics,
                             grid_infos, iso_infos)

    @property
    def _grid_infos(self):
        return self._terms.grid_infos

    def _resolve_grid_force(self, force: GridForce, n_particles,
                            top) -> _GridBindingInfo:
        # auto scaling factors (reference
        # ReferenceGridForceKernels.cpp:162-210; rmin convention of the
        # CUDA/common platforms)
        scaling = np.asarray(force.getScalingFactors(), dtype=np.float64)
        if force.getAutoCalculateScalingFactors() and scaling.size == 0:
            prop = force.getScalingProperty()
            if not prop:
                raise ValueError(
                    "Auto-calculate scaling factors enabled but no scaling "
                    "property specified")
            # Q5: the reference platform auto-scales with (2*sigma)
            # diameter formulas (ReferenceGridForceKernels.cpp:196-205);
            # CUDA/common use Rmin (CudaGridForceKernels.cpp:175-185)
            scaling = np.asarray(auto_scaling_factors(
                prop, top.charges, top.sigmas, top.epsilons,
                convention=("diameter" if self._semantics == "reference"
                            else "rmin")))
            force.setScalingFactors(scaling)

        # tiled generate -> evaluate pipeline (reference
        # CudaGridForceKernels.cpp:323-345, 1411-1658): with a tiled output
        # file configured, auto-generation writes straight to disk and the
        # file becomes the tiled input
        if (force.getAutoGenerateGrid() and force.getTiledOutputFile()
                and not force.getTiledInputFile()):
            from ..ops.gridgen import generate_grid_to_tiled_file
            gt = force.getGridType()
            counts, spacing, _, _ = force.getGridParameters()
            rec = force.getReceptorAtoms()
            lig = set(force.getLigandAtoms())
            if not rec:
                rec = [i for i in range(n_particles) if i not in lig]
            rec_pos = force.getReceptorPositions()
            generate_grid_to_tiled_file(
                force.getTiledOutputFile(), counts, spacing,
                force.getGridOrigin(), gt, rec_pos[:len(rec)],
                top.charges[rec], top.sigmas[rec], top.epsilons[rec],
                tile_size=force.getTiledOutputTileSize(),
                compute_derivatives=force.getComputeDerivatives(),
                grid_cap=force.getGridCap(),
                inv_power=force.getInvPower(),
                inv_power_mode=force.getInvPowerMode(),
                device=self.device)
            force.setTiledInputFile(force.getTiledOutputFile())

        streamer = None
        # a tiled input file always means file-backed evaluation
        if force.getTiledInputFile():
            from ..io.streaming import StreamedGridEvaluator
            streamer = StreamedGridEvaluator(
                force.getTiledInputFile(),
                interp_method=force.getInterpolationMethod(),
                region_shape=(force.getStreamRegionShape()
                              or (64, 64, 64)),
                budget_bytes=force.getMemoryBudgetMB() * 1024 * 1024,
                oob_k=force.getOutOfBoundsRestraint(),
                oob_convention=force.getTiledOOBConvention(),
                device=self.device)
            grid = None
        # auto grid generation (reference :212-278)
        elif force.getAutoGenerateGrid() and force.getNumGridValues() == 0:
            gt = force.getGridType()
            if gt not in ("charge", "ljr", "lja"):
                raise ValueError(f"Invalid grid type '{gt}'")
            counts, spacing, _, _ = force.getGridParameters()
            if len(counts) != 3 or len(spacing) != 3:
                raise ValueError("Grid counts and spacing must be set "
                                 "before auto-generation")
            rec = force.getReceptorAtoms()
            lig = set(force.getLigandAtoms())
            if not rec:
                rec = [i for i in range(n_particles) if i not in lig]
            rec_pos = force.getReceptorPositions()
            if rec_pos.shape[0] == 0:
                raise ValueError("Receptor positions must be set for "
                                 "auto-grid generation")
            if rec_pos.shape[0] < len(rec):
                raise ValueError("Not enough receptor positions provided")
            grid = generate_grid(
                counts, spacing, force.getGridOrigin(), gt,
                rec_pos[:len(rec)],
                top.charges[rec], top.sigmas[rec], top.epsilons[rec],
                compute_derivatives=force.getComputeDerivatives(),
                grid_cap=force.getGridCap(),
                inv_power=force.getInvPower(),
                inv_power_mode=force.getInvPowerMode(),
                interp_method=force.getInterpolationMethod(),
                oob_k=force.getOutOfBoundsRestraint(),
                # Q3: reference-platform generation uses 2*sigma LJ sizes
                lj_convention=("diameter"
                               if self._semantics == "reference"
                               else "rmin"),
                dtype=torch.float64, device=self.device)
            force.setGridValues(grid.vals.cpu().numpy().reshape(-1))
            if grid.derivs is not None:
                force.setDerivatives(np.moveaxis(
                    grid.derivs.cpu().numpy(), -1, 0).reshape(-1))
        else:
            grid = force._build_grid(device=self.device)

        # Q4: the reference platform applies RUNTIME inverse-power as a
        # one-time host-side value transform at Context init
        # (GridForce.cpp:221-272: G -> sign(G)|G|^(1/n), mode -> STORED),
        # then its kernels back-transform on inv_power > 0 alone
        if (self._semantics == "reference" and grid is not None
                and grid.inv_power_mode == 1 and grid.inv_power != 0.0
                and grid.derivs is None):
            v = grid.vals
            sign = torch.where(v >= 0.0, 1.0, -1.0).to(v.dtype)
            v2 = torch.where(v != 0.0,
                             sign * v.abs() ** (1.0 / grid.inv_power), v)
            grid = grid.with_(vals=v2, inv_power_mode=2)

        # atom selection (priority mirrors CudaGridForceKernels.cpp:
        # particle groups > particle filter > ligand atoms > all)
        group_sizes: List[int] = []
        if force.getNumParticleGroups() > 0:
            atom_indices = []
            scal = []
            for gi in range(force.getNumParticleGroups()):
                g = force.getParticleGroup(gi)
                atom_indices.extend(g.particle_indices)
                if g.scaling_factors:
                    scal.extend(g.scaling_factors)
                else:
                    scal.extend(scaling[g.particle_indices])
                group_sizes.append(len(g.particle_indices))
            atom_indices = np.asarray(atom_indices, dtype=np.int64)
            scal = np.asarray(scal, dtype=np.float64)
        elif force.getParticles():
            atom_indices = np.asarray(force.getParticles(), dtype=np.int64)
            scal = scaling[atom_indices]
        elif force.getLigandAtoms():
            atom_indices = np.asarray(force.getLigandAtoms(),
                                      dtype=np.int64)
            # ligand-local scaling factors (reference semantics,
            # ReferenceGridForceKernels.cpp:682-706)
            scal = (scaling[:len(atom_indices)]
                    if len(scaling) == len(atom_indices)
                    else scaling[atom_indices])
        else:
            atom_indices = np.arange(min(len(scaling), n_particles),
                                     dtype=np.int64)
            scal = scaling[:len(atom_indices)]

        # Q1: the reference platform writes grid forces to the LOOP index,
        # not the particle index (ReferenceGridForceKernels.cpp:688 vs
        # :794) — correct only when ligand atoms are 0..N-1; reproduced
        # verbatim in reference semantics
        target = (np.arange(len(atom_indices))
                  if self._semantics == "reference" and streamer is None
                  else atom_indices)

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        return _GridBindingInfo(grid, dev(atom_indices, torch.int64),
                                dev(scal, torch.float64), group_sizes,
                                dev(target, torch.int64), n_particles,
                                streamer=streamer)

    def _rebind_force(self, force):
        self._initialize_forces()
        self._invalidate_stepper()

    # --- public API --------------------------------------------------------
    def getIntegrator(self):
        return self.integrator

    def getSystem(self):
        return self.system

    def _tensor(self, a):
        if isinstance(a, torch.Tensor):
            return a.detach().to(self.device, torch.float64).clone()
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self.device)

    def setPositions(self, positions):
        self._positions = self._tensor(positions)

    def getPositions(self):
        return self._positions.cpu().numpy()

    def setVelocities(self, velocities):
        self._velocities = self._tensor(velocities)

    def setVelocitiesToTemperature(self, temperature, seed=None):
        """Maxwell-Boltzmann velocities from the Context's generator (a
        ``torch.Generator`` on its device, seeded from ``seed`` at
        creation and reseeded by ``seed`` here)."""
        if seed is not None:
            self._generator.manual_seed(int(seed))
        masses = self._core.masses
        sigma_v = torch.sqrt(BOLTZ * temperature / masses)[:, None]
        self._velocities = sigma_v * torch.randn(
            self._positions.shape, generator=self._generator,
            dtype=self._positions.dtype, device=self.device)

    def getState(self, getPositions=False, getVelocities=False,
                 getEnergy=False, getForces=False, groups=None, **_ignored):
        st = State(
            positions=self._positions.cpu().numpy(),
            velocities=(self._velocities.cpu().numpy()
                        if self._velocities is not None else None),
        )
        if getEnergy or getForces:
            gset = set(groups) if groups is not None else None
            e, f = self._terms.terms(self._positions, gset)
            st._energy = float(e)
            st._forces = f.cpu().numpy()
            if self._velocities is not None:
                m = self._core.masses[:, None]
                st._kinetic = float(
                    0.5 * torch.sum(m * self._velocities ** 2))
        return st

    # --- stepping ----------------------------------------------------------
    def _invalidate_stepper(self):
        self._segment = None
        self._stream_engine = None

    def _step_factory(self):
        """``(force_fn, temperature, base_args) -> step`` of the
        integrator, over this Context's masses and constraints."""
        core = self._core
        integ = self.integrator
        if isinstance(integ, LangevinIntegrator):
            dt, friction, scheme = integ.dt, integ.friction, integ.scheme

            def factory(force_fn, t, base_args):
                return make_langevin_step(force_fn, core.masses, dt,
                                          friction, t, scheme=scheme,
                                          constraints=core.constraints)
        elif isinstance(integ, VerletIntegrator):
            dt = integ.dt

            def factory(force_fn, t, base_args):
                return make_verlet_step(force_fn, core.masses, dt,
                                        constraints=core.constraints)
        else:
            raise TypeError(f"unknown integrator {type(integ)}")
        return factory

    def _ensure_stream_engine(self):
        """The ONE streamed-MD engine (mm.StreamedBatchMD) this Context
        delegates streamed stepping and minimization to — a Context is a
        batch of one replica. Streamed GridForces over the same box with
        the same atoms fuse into one StreamSet; the reference applies
        each GridForce's out-of-bounds restraint independently
        (ReferenceGridForceKernels.cpp:1093-1117), so a fused set
        carries the SUM of its forces' restraint k."""
        if self._stream_engine is not None:
            return self._stream_engine
        from ..mm.streamed_md import StreamedBatchMD, StreamSet

        groups = {}
        for idx in sorted(self._grid_infos):
            info = self._grid_infos[idx]
            if info.streamer is None:
                continue
            ev = info.streamer
            # interp_method and per-grid oob_k are part of the key:
            # pack fusion requires both to match across a set's grids
            # (pack_grids_fused raises otherwise), so e.g. a TRILINEAR
            # charge force and a BSPLINE LJ force over the same box
            # must land in separate sets
            key = (tuple(int(c) for c in ev.stream.counts),
                   tuple(np.round(np.asarray(ev.stream.spacing), 12)),
                   tuple(np.round(np.asarray(ev.stream.origin), 12)),
                   tuple(ev.region_shape),
                   int(ev.interp_method), float(ev.oob_k),
                   tuple(info.atom_indices.tolist()))
            groups.setdefault(key, []).append(info)
        sets = [
            StreamSet([i.streamer for i in infos],
                      [i.scaling.cpu().numpy() for i in infos],
                      atom_indices=infos[0].atom_indices.cpu().numpy(),
                      oob_k=sum(float(i.streamer.oob_k) for i in infos),
                      full_region_budget_bytes=int(
                          self.stream_full_region_budget_bytes))
            for infos in groups.values()
        ]
        excl = self._terms.streamed

        def base_force(terms, x):
            return terms.terms(x, None, exclude=excl)[1]

        self._stream_engine = StreamedBatchMD(
            sets=sets,
            refresh_steps=max(1, int(self.stream_refresh_steps)),
            step_factory=self._step_factory(), base_force=base_force)
        return self._stream_engine

    def _recorded_segment(self, step):
        """The in-memory stepping segment on the card: blocks of steps over
        static buffers, recorded as CUDA graphs at first use (no noise
        block for Verlet)."""
        gen = self._generator
        noisy = isinstance(self.integrator, LangevinIntegrator)

        def advance(carry, noise):
            s = step(MDState(carry[0], carry[1], gen), noise)
            return s.positions, s.velocities

        return graphs.Segment(
            advance, (self._positions, self._velocities),
            noise_shape=self._positions.shape if noisy else None)

    def _step(self, n, noise=None):
        """``n`` steps; ``noise`` None (drawn from the Context's generator)
        or [n, N, 3], the Langevin steps' Gaussian numbers."""
        if self._positions is None:
            raise RuntimeError("setPositions first")
        if self._velocities is None:
            self._velocities = torch.zeros_like(self._positions)
        n = int(n)
        temp = float(getattr(self.integrator, "temperature", 0.0))
        if self._terms.streamed:
            # delegate to the batch streamed-MD engine (R=1): running
            # in-segment bbox exactness, chunked re-run recovery with
            # re-centered regions, hysteresis, shared packed-region LRU
            if noise is not None:
                raise ValueError("streamed stepping draws its own noise")
            eng = self._ensure_stream_engine()
            eng.refresh_steps = max(1, int(self.stream_refresh_steps))
            states = MDState(self._positions[None], self._velocities[None],
                             self._generator)
            out = eng.run(states, np.asarray([temp]), n,
                          base_args=self._terms)
            self._positions = out.positions[0]
            self._velocities = out.velocities[0]
            return
        self._temperature.fill_(temp)
        if self._segment is None:
            terms = self._terms

            def force_fn(x):
                return terms.terms(x)[1]

            step = self._step_factory()(force_fn, self._temperature, terms)
            self._segment = (self._recorded_segment(step)
                             if self._positions.is_cuda else step)
        if isinstance(self._segment, graphs.Segment):
            self._positions, self._velocities = self._segment.run(
                (self._positions, self._velocities), n, noise=noise,
                generator=self._generator)
        else:
            out = run_segment(self._segment, MDState(
                self._positions, self._velocities, self._generator), n,
                noise=noise)
            self._positions, self._velocities = out.positions, out.velocities

    def _minimize_streamed(self, maxIterations, tolerance, chunk=25):
        """L-BFGS minimization over streamed (tiled-file) grids with the
        SAME exactness guarantee as streamed stepping: the loop runs in
        segments that carry a RUNNING in-grid cloud bbox per stream set
        (the min/max over every iterate, so excursions that self-reverse
        are still seen); a segment whose bbox leaves a region interior is
        DISCARDED and re-run with the violators' regions re-centered on
        the current cloud. Mirrors the reference's tiled semantics where
        every evaluation sees exact tiles (CudaGridForceKernels.cpp:
        888-975). Region state (hysteresis, packed LRU) is shared with the
        stepping engine. A cloud that no bounded region holds escalates
        to the full-grid payload on the Context's device, within
        ``stream_full_region_budget_bytes``."""
        from ..mm.streamed_md import _cloud_bounds, _set_forces, _sub

        eng = self._ensure_stream_engine()
        sets = eng.sets
        terms = self._terms
        excl = terms.streamed
        x = self._positions
        n_atoms = x.shape[0]
        metas = [s.device_tensors(x.dtype, x.device) + (
            s.gather_index(n_atoms), float(s.oob_k)) for s in sets]

        def segment(x0, st, it0, payloads):
            def value_and_grad(p):
                e, f = terms.terms(p, None, exclude=excl)
                for (scal, box, gather, k), pay in zip(metas, payloads):
                    e_s, f_s = _set_forces(p, pay, scal, box, k, gather,
                                           energy=True)
                    e, f = e + e_s, f + f_s
                return e, -f

            def bbox(p):
                return [_cloud_bounds(_sub(p, gather), *box)
                        for _, box, gather, _ in metas]

            pt = lbfgs.point(x0, value_and_grad)
            runs = bbox(x0)
            it, k = it0, 0
            while (k < chunk and it < maxIterations
                   and pt.rms() >= tolerance):
                pt, st = lbfgs.minimize_step(st, pt, value_and_grad)
                runs = [(torch.minimum(rl, lo), torch.maximum(rh, hi))
                        for (rl, rh), (lo, hi) in zip(runs, bbox(pt.x))]
                it, k = it + 1, k + 1
            b = torch.stack([torch.cat([rl, rh]) for rl, rh in runs])
            return pt, st, it, b.cpu().numpy()               # [S, 6]

        st = lbfgs.init(x)
        it = 0
        retries = 0
        while it < int(maxIterations):
            # region assignment for the CURRENT cloud (R=1), through the
            # shared per-set hysteresis/re-centering machinery; a new
            # round unpins last round's packs
            set_starts = []
            for s in sets:
                s.begin_round()
            for s, (_, box, _, _) in zip(sets, metas):
                l0, h0 = (t.cpu().numpy() for t in
                          _cloud_bounds(s.take(x)[None], *box))
                set_starts.append(s.assign(
                    (l0, h0, np.isfinite(l0).all(axis=1))))
            payloads, interiors = [], []
            for s, ss in zip(sets, set_starts):
                pay, interior = s.payload(ss[0])
                payloads.append(pay)
                interiors.append(interior)
            pt, st2, it2, b = segment(x, st, it, payloads)
            bad_sets = []
            for si, s in enumerate(sets):
                rlo, rhi = b[si, 0:3], b[si, 3:6]
                if not np.isfinite(rlo).all():
                    continue               # all-outside: restraint only
                ilo, ihi = interiors[si]
                if not (np.all(rlo >= ilo) and np.all(rhi <= ihi)):
                    bad_sets.append(si)
            if bad_sets:
                retries += 1
                if retries > 4:
                    raise RuntimeError(
                        "minimization cloud crossed its streamed region "
                        "boundary repeatedly; enlarge region_shape "
                        "(GridForce.setMemoryBudgetMB)")
                for si in bad_sets:
                    sets[si]._recenter = np.array([True])
                continue                   # discard segment, re-run
            retries = 0
            rms = pt.rms()
            stuck = it2 == it             # segment made no iterations
            x, st, it = pt.x, st2, it2
            if rms < float(tolerance):
                break
            if not np.isfinite(rms) or stuck:
                # a non-finite gradient (overlapping atoms, inv-power
                # pole) ends the loop at once with no iteration and a NaN
                # rms that satisfies neither comparison — re-running the
                # identical segment would spin forever
                break
        self._positions = x

    # --- group / atom energy queries (GridForce companions) ----------------
    def _grid_eval(self, info):
        pos = self._positions[info.atom_indices]
        if info.streamer is not None:
            return info.streamer.evaluate(pos, info.scaling)
        return evaluate_grid(info.grid, pos, info.scaling)

    def _grid_group_energies(self, force: GridForce):
        idx = self.system.getForces().index(force)
        info = self._grid_infos[idx]
        if not info.group_sizes:
            return []
        pa = self._grid_eval(info).per_atom_energy.cpu().numpy()
        out = []
        off = 0
        for size in info.group_sizes:
            out.append(float(pa[off:off + size].sum()))
            off += size
        return out

    def _grid_atom_energies(self, force: GridForce):
        idx = self.system.getForces().index(force)
        info = self._grid_infos[idx]
        return list(self._grid_eval(info).per_atom_energy.cpu().numpy())


class Simulation:
    """Minimal mirror of openmm.app.Simulation, on ``device`` (the CUDA
    card unless ``device="cpu"``)."""

    def __init__(self, topology, system: ApiSystem, integrator,
                 platform=None, device=None):
        self.topology = topology
        self.system = system
        self.integrator = integrator
        self.context = Context(system, integrator, platform, device=device)
        # iterations of the last minimizeEnergy
        self.minimizer_iterations = 0

    def step(self, n):
        self.integrator.step(n)

    def minimizeEnergy(self, maxIterations=200, tolerance=10.0):
        """L-BFGS energy minimization (``api/lbfgs.py``, the algorithm of
        optax's ``lbfgs()``), mirroring OpenMM's LocalEnergyMinimizer role.
        ``tolerance`` is the RMS force target in kJ/mol/nm. A host loop
        over device vectors: one synchronisation per line-search trial.
        With streamed (tiled-file) grids the loop runs in validated
        segments instead — see Context._minimize_streamed."""
        ctx = self.context
        if ctx._terms.streamed:
            ctx._minimize_streamed(maxIterations, tolerance)
            return
        vg = ctx._terms.value_and_grad
        pt = lbfgs.point(ctx._positions, vg)
        st = lbfgs.init(pt.x)
        it = 0
        while it < maxIterations and pt.rms() >= tolerance:
            pt, st = lbfgs.minimize_step(st, pt, vg)
            it += 1
        ctx._positions = pt.x
        self.minimizer_iterations = it

    def _ctx_positions(self):
        return self.context._positions


def clearGridCache():
    """Clear the shared grid-file cache (SWIG ``clearGridCache``)."""
    from .gridforce import clear_grid_cache

    clear_grid_cache()
    return None
