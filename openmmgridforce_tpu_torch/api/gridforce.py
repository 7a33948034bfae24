"""Stateful ``GridForce`` mirroring the reference public API.

The port of the JAX package's ``api/gridforce.py``: a thin imperative
shell over the functional core, so that code written against the
reference's SWIG module (reference python/gridforceplugin.i:1-384,
openmmapi/include/GridForce.h:83-713) translates nearly 1:1. The state
stays numpy on the host; at Context creation it is materialized into a
frozen :class:`~openmmgridforce_tpu_torch.grid.Grid` on the Context's
device plus atom/scaling bindings (the functional dataflow replacing the
reference's mutate-during-initialize pattern, GridForceImpl.cpp:55-62).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import List, Optional

import numpy as np
import torch

from ..grid import Grid, InterpolationMethod, InvPowerMode, grid_from_numpy
from ..units import DEFAULT_GRID_CAP, DEFAULT_OOB_K

# Flattened enum constants matching the SWIG wrapper
# (gridforceplugin.i InvPowerMode_NONE/RUNTIME/STORED).
InvPowerMode_NONE = int(InvPowerMode.NONE)
InvPowerMode_RUNTIME = int(InvPowerMode.RUNTIME)
InvPowerMode_STORED = int(InvPowerMode.STORED)


class ContextRef:
    """The Context a force or an integrator is bound to, held weakly: the
    Context holds them, so a strong back-reference would be a cycle that
    keeps a dropped Context's recording and grids on the device until the
    next garbage collection. ``None`` when unbound or dropped."""

    def __set_name__(self, owner, name):
        self._slot = f"_{name}_ref"

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        ref = obj.__dict__.get(self._slot)
        return None if ref is None else ref()

    def __set__(self, obj, context):
        obj.__dict__[self._slot] = (None if context is None
                                    else weakref.ref(context))


@dataclasses.dataclass
class ParticleGroup:
    """Named multi-ligand particle group (reference GridForce.h:56-77)."""

    name: str
    particle_indices: List[int]
    scaling_factors: List[float]


class GridData:
    """Shared grid-data container mirroring the reference ``GridData``
    (reference python/gridforceplugin.i:101-157,
    openmmapi/include/GridData.h). Where the reference shares one
    ``shared_ptr<GridData>`` between forces to avoid duplicating large
    grids, here the arrays are numpy and sharing falls out of Python
    reference semantics: pass the same ``GridData`` to several
    :class:`GridForce` objects and they alias one buffer.

    SWIG's ``%apply ... OUTPUT`` turns the reference's by-reference
    getters into tuple returns in Python, so ``getCounts()`` /
    ``getSpacing()`` / ``getOrigin()`` return 3-tuples here too.
    """

    def __init__(self, nx=0, ny=0, nz=0, dx=0.0, dy=0.0, dz=0.0):
        self._counts = [int(nx), int(ny), int(nz)]
        self._spacing = [float(dx), float(dy), float(dz)]
        self._origin = [0.0, 0.0, 0.0]
        self._vals = np.zeros(0, dtype=np.float64)
        self._derivs: Optional[np.ndarray] = None
        self._grid_type = ""
        self._inv_power = 0.0
        self._inv_power_mode = 0

    # --- file I/O (reference GridData.cpp V3 container variant) ----------
    @staticmethod
    def loadFromFile(filename) -> "GridData":
        from ..io import load_v3

        data = load_v3(filename)
        gd = GridData(*data.counts, *data.spacing)
        gd._origin = list(data.origin)
        gd._vals = np.asarray(data.vals, dtype=np.float64).reshape(-1)
        if data.derivs is not None:
            gd._derivs = np.asarray(data.derivs,
                                    dtype=np.float64).reshape(-1)
        gd._grid_type = data.grid_type
        gd._inv_power = float(data.inv_power)
        gd._inv_power_mode = int(data.inv_power_mode)
        return gd

    def saveToFile(self, filename):
        from ..io import save_v3_griddata

        n = int(np.prod(self._counts))
        if self._vals.size != n:
            raise ValueError("Number of grid values doesn't match "
                             "dimensions")
        derivs = None
        if self._derivs is not None and self._derivs.size:
            derivs = self._derivs.reshape((27,) + tuple(self._counts))
        save_v3_griddata(filename, self._counts, self._spacing,
                         self._origin, self._vals,
                         derivs=derivs, inv_power=self._inv_power,
                         inv_power_mode=self._inv_power_mode)

    # --- dimensions -------------------------------------------------------
    def getNx(self):
        return self._counts[0]

    def getNy(self):
        return self._counts[1]

    def getNz(self):
        return self._counts[2]

    def getCounts(self):
        return tuple(self._counts)

    # --- spacing ----------------------------------------------------------
    def getDx(self):
        return self._spacing[0]

    def getDy(self):
        return self._spacing[1]

    def getDz(self):
        return self._spacing[2]

    def getSpacing(self):
        return tuple(self._spacing)

    # --- origin -----------------------------------------------------------
    def getOrigin(self):
        return tuple(self._origin)

    def setOrigin(self, x, y, z):
        self._origin = [float(x), float(y), float(z)]

    # --- data -------------------------------------------------------------
    def getValues(self):
        return self._vals

    def setValues(self, vals):
        self._vals = np.asarray(vals, dtype=np.float64).reshape(-1)

    def getDerivatives(self):
        return (self._derivs if self._derivs is not None
                else np.zeros(0, dtype=np.float64))

    def setDerivatives(self, derivs):
        self._derivs = np.asarray(derivs, dtype=np.float64).reshape(-1)

    def hasDerivatives(self):
        return self._derivs is not None and self._derivs.size > 0

    # --- metadata ---------------------------------------------------------
    def getGridType(self):
        return self._grid_type

    def setGridType(self, grid_type):
        self._grid_type = str(grid_type)

    def getInvPower(self):
        return self._inv_power


class Force:
    """Base: force-group bookkeeping (OpenMM::Force surface subset)."""

    def __init__(self):
        self._force_group = 0

    def setForceGroup(self, group: int):
        if not 0 <= group < 32:
            raise ValueError("force group must be in [0, 31]")
        self._force_group = int(group)

    def getForceGroup(self) -> int:
        return self._force_group


class GridForce(Force):
    _context = ContextRef()     # filled at Context creation

    def __init__(self, grid_data: Optional[GridData] = None):
        super().__init__()
        self._counts: List[int] = []
        self._spacing: List[float] = []
        self._origin = [0.0, 0.0, 0.0]
        self._vals: List[float] = []
        self._vals_array: Optional[np.ndarray] = None
        self._derivatives: Optional[np.ndarray] = None
        self._scaling_factors: List[float] = []
        self._inv_power = 0.0
        self._inv_power_mode = InvPowerMode.NONE
        self._grid_cap = DEFAULT_GRID_CAP
        self._oob_k = DEFAULT_OOB_K
        self._interpolation_method = 0
        self._auto_scaling = False
        self._scaling_property = ""
        self._auto_generate = False
        self._grid_type = ""
        self._compute_derivatives = False
        self._particles: List[int] = []
        self._particle_groups: List[ParticleGroup] = []
        self._receptor_atoms: List[int] = []
        self._ligand_atoms: List[int] = []
        self._receptor_positions: Optional[np.ndarray] = None
        self._tiled_mode = False
        self._tile_size = 64
        self._memory_budget_mb = 2048
        self._tiled_output_file = ""
        self._tiled_output_tile_size = 32
        self._tiled_input_file = ""
        self._grid_data: Optional[GridData] = None
        if grid_data is not None:
            self.setGridData(grid_data)

    # --- shared GridData container (reference GridForce.h:90-92) -------
    def setGridData(self, grid_data: GridData):
        """Adopt a shared :class:`GridData` container. Geometry and
        metadata are copied (as the reference copies them into
        ``m_counts``/``m_spacing``, GridForce.cpp:107-132); values and
        derivatives are read AND written *through* the container — the
        reference keeps ``m_vals = gridData->getValuesPtr()`` so a later
        ``GridData.setValues`` or a sibling force's ``setGridValues``
        is visible to every force aliasing the container."""
        self._grid_data = grid_data
        self._counts = list(grid_data.getCounts())
        self._spacing = list(grid_data.getSpacing())
        self._origin = list(grid_data.getOrigin())
        self._vals = []
        self._vals_array = None
        if grid_data.getGridType():
            self._grid_type = grid_data.getGridType()
        if grid_data.getInvPower():
            self._inv_power = grid_data.getInvPower()
            self._inv_power_mode = InvPowerMode(
                grid_data._inv_power_mode)

    def getGridData(self) -> Optional[GridData]:
        return self._grid_data

    # --- grid geometry / data -----------------------------------------
    def addGridCounts(self, nx, ny, nz):
        self._counts = [int(nx), int(ny), int(nz)]

    def addGridSpacing(self, dx, dy, dz):
        self._spacing = [float(dx), float(dy), float(dz)]

    def setGridOrigin(self, x, y, z):
        self._origin = [float(x), float(y), float(z)]

    def getGridOrigin(self):
        return tuple(self._origin)

    def addGridValue(self, val):
        if self._grid_data is not None:  # m_vals->push_back (:166-168)
            gd = self._grid_data
            gd.setValues(np.append(gd.getValues(), float(val)))
            return
        self._vals.append(float(val))
        self._vals_array = None

    def setGridValues(self, vals):
        if self._grid_data is not None:  # *m_vals = vals (:170-172)
            self._grid_data.setValues(vals)
            return
        self._vals_array = np.asarray(vals, dtype=np.float64).reshape(-1)
        self._vals = []

    def getGridValues(self):
        return list(self._values_flat())

    def _values_flat(self) -> np.ndarray:
        if self._grid_data is not None:
            return self._grid_data.getValues()
        if self._vals_array is not None:
            return self._vals_array
        return np.asarray(self._vals, dtype=np.float64)

    def getNumGridValues(self):
        return len(self._values_flat())

    def clearGridData(self):
        # Documented no-op under the shared-data design
        # (reference GridForce.cpp:429-434).
        pass

    # --- scaling factors ----------------------------------------------
    def addScalingFactor(self, val):
        self._scaling_factors.append(float(val))

    def setScalingFactor(self, index, val):
        self._scaling_factors[index] = float(val)

    def setScalingFactors(self, vals):
        self._scaling_factors = [float(v) for v in vals]

    def getScalingFactors(self):
        return list(self._scaling_factors)

    def getNumScalingFactors(self):
        return len(self._scaling_factors)

    def setAutoCalculateScalingFactors(self, enable):
        self._auto_scaling = bool(enable)

    def getAutoCalculateScalingFactors(self):
        return self._auto_scaling

    def setScalingProperty(self, prop):
        if prop not in ("charge", "ljr", "lja"):
            raise ValueError(
                f"Invalid scaling property '{prop}'. Must be 'charge', "
                "'ljr', or 'lja'")
        self._scaling_property = prop

    def getScalingProperty(self):
        return self._scaling_property

    # --- transforms / caps ----------------------------------------------
    def setInvPowerMode(self, mode, inv_power):
        self._inv_power_mode = InvPowerMode(int(mode))
        self._inv_power = float(inv_power)

    def getInvPowerMode(self):
        return int(self._inv_power_mode)

    def getInvPower(self):
        return self._inv_power

    def applyInvPowerTransformation(self):
        """Host-side RUNTIME transform of stored values G -> G^(1/n)
        (reference GridForce.cpp:221-272)."""
        if self._inv_power <= 0.0:
            return
        vals = self._values_flat()
        sign = np.where(vals >= 0.0, 1.0, -1.0)
        self.setGridValues(sign * np.abs(vals) ** (1.0 / self._inv_power))

    def setGridCap(self, u_max):
        self._grid_cap = float(u_max)

    def getGridCap(self):
        return self._grid_cap

    def setOutOfBoundsRestraint(self, k):
        self._oob_k = float(k)

    def getOutOfBoundsRestraint(self):
        return self._oob_k

    def setInterpolationMethod(self, method):
        if not 0 <= int(method) <= 3:
            raise ValueError("interpolation method must be 0-3")
        self._interpolation_method = int(method)

    def getInterpolationMethod(self):
        return self._interpolation_method

    # --- auto generation -------------------------------------------------
    def setAutoGenerateGrid(self, enable):
        self._auto_generate = bool(enable)

    def getAutoGenerateGrid(self):
        return self._auto_generate

    def setGridType(self, grid_type):
        if grid_type not in ("charge", "ljr", "lja"):
            raise ValueError(
                f"Invalid grid type '{grid_type}'. Must be 'charge', "
                "'ljr', or 'lja'")
        self._grid_type = grid_type

    def getGridType(self):
        return self._grid_type

    def setComputeDerivatives(self, compute):
        self._compute_derivatives = bool(compute)

    def getComputeDerivatives(self):
        return self._compute_derivatives

    def _derivs_flat(self) -> Optional[np.ndarray]:
        if self._grid_data is not None:
            return (self._grid_data.getDerivatives().reshape(-1)
                    if self._grid_data.hasDerivatives() else None)
        return (self._derivatives.reshape(-1)
                if self._derivatives is not None else None)

    def hasDerivatives(self):
        return self._derivs_flat() is not None

    def getDerivatives(self):
        d = self._derivs_flat()
        return np.zeros(0) if d is None else d

    def setDerivatives(self, derivs):
        if self._grid_data is not None:
            self._grid_data.setDerivatives(derivs)
            return
        self._derivatives = np.asarray(derivs, dtype=np.float64)

    # --- atom selections ---------------------------------------------
    def setParticles(self, particles):
        self._particles = [int(p) for p in particles]

    def getParticles(self):
        return list(self._particles)

    def setReceptorAtoms(self, atoms):
        self._receptor_atoms = [int(a) for a in atoms]

    def getReceptorAtoms(self):
        return list(self._receptor_atoms)

    def setLigandAtoms(self, atoms):
        self._ligand_atoms = [int(a) for a in atoms]

    def getLigandAtoms(self):
        return list(self._ligand_atoms)

    def setReceptorPositions(self, positions):
        self._receptor_positions = np.asarray(positions, dtype=np.float64)

    def setReceptorPositionsFromLists(self, positions):
        self.setReceptorPositions(positions)

    def setReceptorPositionsFromArrays(self, x, y, z):
        self._receptor_positions = np.stack(
            [np.asarray(x), np.asarray(y), np.asarray(z)], axis=-1)

    def getReceptorPositions(self):
        return (np.zeros((0, 3)) if self._receptor_positions is None
                else self._receptor_positions)

    # --- particle groups -----------------------------------------------
    def addParticleGroup(self, name, particle_indices, scaling_factors=None):
        for g in self._particle_groups:
            if g.name == name:
                raise ValueError(f"Particle group '{name}' already exists")
        self._particle_groups.append(ParticleGroup(
            name=name,
            particle_indices=[int(i) for i in particle_indices],
            scaling_factors=[float(s) for s in (scaling_factors or [])],
        ))
        return len(self._particle_groups) - 1

    def getNumParticleGroups(self):
        return len(self._particle_groups)

    def getParticleGroup(self, index):
        return self._particle_groups[index]

    def getParticleGroupByName(self, name):
        for g in self._particle_groups:
            if g.name == name:
                return g
        return None

    def removeParticleGroup(self, index):
        del self._particle_groups[index]

    def clearParticleGroups(self):
        self._particle_groups = []

    def getParticleGroupEnergies(self, context=None):
        ctx = context or self._context
        if ctx is None:
            return []
        return ctx._grid_group_energies(self)

    def getParticleAtomEnergies(self, context=None):
        ctx = context or self._context
        if ctx is None:
            return []
        return ctx._grid_atom_energies(self)

    # --- tiled mode -----------------------------------------------------
    def setTiledMode(self, enable, tile_size=64, memory_budget_mb=2048):
        self._tiled_mode = bool(enable)
        self._tile_size = int(tile_size)
        self._memory_budget_mb = int(memory_budget_mb)

    def getTiledMode(self):
        return self._tiled_mode

    def getTileSize(self):
        return self._tile_size

    def getMemoryBudgetMB(self):
        return self._memory_budget_mb

    def setTiledOOBConvention(self, convention):
        """Out-of-bounds restraint convention for tiled-file evaluation:
        "reference" (default, E = 1/2 k d^2) or "cuda-tiled" (the
        reference CUDA tiled kernel's quirk Q7: E = k d^2, F = -2k dev,
        gridForceTiled.cu:522-550). Opt-in — the engine does not
        reproduce the tiled/non-tiled inconsistency by default."""
        if convention not in ("reference", "cuda-tiled"):
            raise ValueError(f"unknown convention {convention!r}")
        self._tiled_oob_convention = convention

    def getTiledOOBConvention(self):
        return getattr(self, "_tiled_oob_convention", "reference")

    def setStreamRegionShape(self, nx, ny, nz):
        """An extension (no reference equivalent): the fixed
        region shape (grid points per axis) streamed to the device for
        tiled-file evaluation/MD. Smaller regions bound device memory
        (a 64^3 triquintic packed region is ~200 MB) at the price of
        more frequent refreshes for fast-drifting clouds; the shape is
        clamped to the grid counts per axis."""
        self._stream_region_shape = (int(nx), int(ny), int(nz))

    def getStreamRegionShape(self):
        return getattr(self, "_stream_region_shape", None)

    def setTiledOutputFile(self, filename, tile_size=32):
        self._tiled_output_file = filename
        self._tiled_output_tile_size = int(tile_size)

    def getTiledOutputFile(self):
        return self._tiled_output_file

    def getTiledOutputTileSize(self):
        return self._tiled_output_tile_size

    def setTiledInputFile(self, filename):
        self._tiled_input_file = filename

    def getTiledInputFile(self):
        return self._tiled_input_file

    # --- file I/O ------------------------------------------------------
    def loadFromFile(self, filename):
        data = _load_v3_cached(filename, int(self._inv_power_mode),
                               self._inv_power)
        self._counts = list(data.counts)
        self._spacing = list(data.spacing)
        self._origin = list(data.origin)
        self.setGridValues(data.vals.reshape(-1))
        if data.derivs is not None:
            self.setDerivatives(data.derivs)
        elif self._grid_data is None:
            self._derivatives = None
        self._inv_power = data.inv_power
        self._inv_power_mode = InvPowerMode(data.inv_power_mode)
        if data.grid_type:
            self._grid_type = data.grid_type

    def saveToFile(self, filename):
        from ..io import save_v3

        if len(self._counts) != 3 or len(self._spacing) != 3:
            raise ValueError("Grid dimensions must be set before saving")
        vals = self._values_flat()
        expected = int(np.prod(self._counts))
        if len(vals) != expected:
            raise ValueError(
                "Number of grid values doesn't match dimensions")
        derivs = self._derivs_flat()
        if derivs is not None and derivs.size:
            derivs = derivs.reshape((27,) + tuple(self._counts))
        else:
            derivs = None
        save_v3(filename, self._counts, self._spacing, self._origin,
                vals.reshape(tuple(self._counts)), derivs=derivs,
                grid_type=self._grid_type, inv_power=self._inv_power,
                inv_power_mode=int(self._inv_power_mode))

    # --- introspection ---------------------------------------------------
    def getGridParameters(self):
        """Returns (counts, spacing, vals, scaling_factors)."""
        return (list(self._counts), list(self._spacing),
                list(self._values_flat()), list(self._scaling_factors))

    def updateParametersInContext(self, context):
        context._rebind_force(self)

    # --- materialization (called by Context) ------------------------------
    def _build_grid(self, dtype=torch.float64, device=None) -> Grid:
        """The force's grid on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        if len(self._counts) != 3 or len(self._spacing) != 3:
            raise ValueError("Grid counts and spacing must be set")
        vals = self._values_flat()
        counts = tuple(self._counts)
        derivs = self._derivs_flat()
        if derivs is not None and derivs.size:
            derivs = derivs.reshape((27,) + counts)
        else:
            derivs = None
        return grid_from_numpy(
            vals.reshape(counts), self._spacing, self._origin,
            derivs=derivs,
            interp_method=InterpolationMethod(self._interpolation_method),
            inv_power_mode=self._inv_power_mode,
            inv_power=self._inv_power,
            grid_cap=self._grid_cap,
            oob_k=self._oob_k,
            grid_type=self._grid_type,
            dtype=dtype,
            device=device,
        )


# Per-file grid cache mirroring GridDataCache (reference
# openmmapi/include/CachedGridData.h:141-208): repeated loads of the same
# file with the same transform configuration share one parsed copy. The
# port's own cache: the JAX package's files are never shared with it.
_GRID_FILE_CACHE = {}


def _load_v3_cached(filename, mode, inv_power):
    import os

    from ..io import load_v3

    key = (os.path.abspath(filename), mode, float(inv_power))
    mtime = os.path.getmtime(filename)
    hit = _GRID_FILE_CACHE.get(key)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    data = load_v3(filename)
    _GRID_FILE_CACHE[key] = (mtime, data)
    return data


def clear_grid_cache():
    """Drop all cached grid file data (SWIG ``clearGridCache``,
    gridforceplugin.i:368-383)."""
    _GRID_FILE_CACHE.clear()


def castToGridForce(force):
    """Downcast helper mirroring the SWIG utility
    (gridforceplugin.i:344-360)."""
    return force if isinstance(force, GridForce) else None
