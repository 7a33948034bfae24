"""Grid generation split over ranks: each rank computes an x-slab.

The counterpart of the JAX package's ``parallel/sharded_gridgen.py``.
Generation is embarrassingly parallel over grid points: rank i of the
axis computes x-rows [i*per, min((i+1)*per, nx)), per = ceil(nx / n),
through the same kernels as ``ops/gridgen.generate_grid`` (K1 for values;
K2 and the chain rules for the 27 derivatives; their plain twins on the
host) at the slab's index offset, so every point is formed from its
global index and the union of the slabs is the one-rank grid bit for bit.
With nx < n * per the last ranks get fewer rows, or none: a rank without
rows launches no kernel and still joins every collective.

The slab stays on its rank: it is packed there (``sharded_grid.
pack_sharded``) with a halo of a few x-planes from its neighbours, or
gathered whole onto every rank with :meth:`GridSlab.gather`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..grid import Grid, InterpolationMethod, InvPowerMode
from ..ops import gridgen as _gg
from ..units import DEFAULT_GRID_CAP, DEFAULT_OOB_K
from .mesh import Mesh


def slab_rows(nx: int, n: int, i: int) -> tuple:
    """The x-rows [x0, x1) of rank ``i`` of ``n`` over ``nx`` rows."""
    per = -(-nx // n)
    return min(i * per, nx), min((i + 1) * per, nx)


@dataclasses.dataclass
class GridSlab:
    """This rank's x-rows [x0, x1) of a grid of ``counts`` points, with the
    grid's configuration (the fields of ``Grid``)."""

    vals: torch.Tensor                 # [x1 - x0, ny, nz]
    derivs: torch.Tensor | None        # [x1 - x0, ny, nz, 27] or None
    x_range: tuple
    counts: tuple
    spacing: torch.Tensor
    origin: torch.Tensor
    interp_method: int
    inv_power_mode: int
    inv_power: float
    grid_cap: float
    oob_k: float
    grid_type: str
    mesh: Mesh
    axis: str

    def _gather(self, part):
        nx = self.counts[0]
        n = self.mesh.size(self.axis)
        per = -(-nx // n)
        x0, x1 = self.x_range
        padded = part.new_zeros((per,) + tuple(part.shape[1:]))
        padded[:x1 - x0] = part
        return self.mesh.all_gather(padded, self.axis)[:nx]

    def gather(self) -> Grid:
        """The whole grid on every rank of the axis (a collective)."""
        derivs = None if self.derivs is None else self._gather(self.derivs)
        vals = derivs[..., 0] if derivs is not None else self._gather(
            self.vals)
        return Grid(vals=vals, derivs=derivs, spacing=self.spacing,
                    origin=self.origin, counts=self.counts,
                    interp_method=self.interp_method,
                    inv_power_mode=self.inv_power_mode,
                    inv_power=self.inv_power, grid_cap=self.grid_cap,
                    oob_k=self.oob_k, grid_type=self.grid_type)


def generate_grid_sharded(mesh: Mesh,
                          counts,
                          spacing,
                          origin,
                          grid_type: str,
                          receptor_positions,
                          charges,
                          sigmas,
                          epsilons,
                          *,
                          axis: str = "sp",
                          compute_derivatives: bool = False,
                          grid_cap: float = DEFAULT_GRID_CAP,
                          inv_power: float = 0.0,
                          inv_power_mode: InvPowerMode = InvPowerMode.NONE,
                          interp_method: InterpolationMethod =
                          InterpolationMethod.TRILINEAR,
                          oob_k: float = DEFAULT_OOB_K,
                          lj_convention: str = "rmin",
                          dtype=torch.float32,
                          device=None) -> GridSlab:
    """Generate this rank's x-slab of one receptor grid over ``axis``.

    The arguments are ``ops/gridgen.generate_grid``'s; ``device`` defaults
    to the mesh's. Semantics (clamps, tanh cap, inverse-power storage
    transform, cell-fractional derivative scaling) are generate_grid's,
    and so is its memory guard, on this rank's slab and device.
    """
    _gg._check_dtype(dtype)
    device = resolve_device(device if device is not None else mesh.device)
    counts = tuple(int(c) for c in counts)
    nx, ny, nz = counts
    x0, x1 = slab_rows(nx, mesh.size(axis), mesh.index(axis))
    shape = (x1 - x0, ny, nz)
    _gg._check_grid_fits(shape[0] * ny * nz, compute_derivatives,
                         torch.empty((), dtype=dtype).element_size(), device)
    derivs = None
    if x1 == x0:
        vals = torch.empty(shape, dtype=dtype, device=device)
        if compute_derivatives:
            derivs = torch.empty(shape + (_gg.N_DERIVS,), dtype=dtype,
                                 device=device)
            vals = derivs[..., 0]
    else:
        atoms = _gg.receptor_atoms(grid_type, receptor_positions, charges,
                                   sigmas, epsilons, lj_convention, dtype,
                                   device)
        if compute_derivatives:
            raw = _gg.gridgen_derivs(atoms, shape, spacing, origin,
                                     grid_type, index_offset=(x0, 0, 0))
            derivs = _gg._postprocess_raw_derivs(
                raw, grid_cap=grid_cap, inv_power=inv_power,
                inv_power_mode=inv_power_mode, spacing=spacing)
            vals = derivs[..., 0]
        else:
            vals = _gg._store_transform(
                _gg.gridgen_values(atoms, shape, spacing, origin, grid_type,
                                   grid_cap, index_offset=(x0, 0, 0)),
                inv_power, inv_power_mode)
    return GridSlab(
        vals=vals, derivs=derivs, x_range=(x0, x1), counts=counts,
        spacing=torch.tensor(spacing, dtype=dtype, device=device),
        origin=torch.tensor(origin, dtype=dtype, device=device),
        interp_method=int(interp_method),
        inv_power_mode=int(inv_power_mode), inv_power=float(inv_power),
        grid_cap=float(grid_cap), oob_k=float(oob_k), grid_type=grid_type,
        mesh=mesh, axis=axis)
