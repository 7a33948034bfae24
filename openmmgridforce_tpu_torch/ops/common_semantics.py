"""Common-platform (OpenCL/portable) kernel semantics: quirk Q6 and the
common platform's inverse power.

The port of the JAX package's ``ops/common_semantics.py``. The reference's
portable kernel (platforms/common/src/gridForce.cc) differs from the
reference and CUDA kernels:

- **Q6**: the out-of-bounds restraint FORCE is scaled by the atom's
  scaling factor while the restraint ENERGY is not (gridForce.cc:214-217).
  An atom with scaling exactly 0 is skipped entirely (gridForce.cc:40-45):
  no energy, no force, not even the restraint.
- the inverse power is a bare power transform applied whenever
  ``inv_power > 0``: no sign handling and no mode check
  (gridForce.cc:180-187).
- only trilinear and cubic B-spline interpolation exist.

The cell and fraction are the default kernels' (``interpolate.locate``),
and so are the stencils. Pure tensor code on the device of its inputs.
"""

from __future__ import annotations

import torch

from ..grid import Grid, InterpolationMethod
from .interpolate import (GridEval, _interp_bspline, _interp_trilinear,
                          locate, oob_deviation)


def evaluate_grid_common(grid: Grid, positions, scaling_factors
                         ) -> GridEval:
    """Energy and forces with the common platform's kernel semantics, for
    positions [..., N, 3]."""
    if grid.interp_method not in (InterpolationMethod.TRILINEAR,
                                  InterpolationMethod.BSPLINE):
        raise ValueError(
            "the Common/OpenCL platform supports only trilinear and "
            "B-spline interpolation (CommonGridForceKernels.cpp "
            "compiles no Hermite branch)")
    dtype = grid.vals.dtype
    positions = torch.as_tensor(positions, dtype=dtype,
                                device=grid.vals.device)
    scaling = torch.as_tensor(scaling_factors, dtype=dtype,
                              device=positions.device)
    pos, corner, inside, ixyz, f = locate(positions, grid.spacing,
                                          grid.origin, grid.counts)
    if grid.interp_method == InterpolationMethod.TRILINEAR:
        interp, grad_s = _interp_trilinear(grid, ixyz, f)
    else:
        interp, grad_s = _interp_bspline(grid, ixyz, f)

    # bare power transform whenever invPower > 0 (gridForce.cc:180-187)
    if grid.inv_power > 0.0:
        p = grid.inv_power
        factor = p * interp ** (p - 1.0)
        interp = interp ** p
        grad_s = grad_s * factor[..., None]

    grad_phys = grad_s / grid.spacing
    energy_in = scaling * interp
    force_in = -scaling[..., None] * grad_phys

    dev = oob_deviation(pos, corner)
    # Q6: energy unscaled, force scaled (gridForce.cc:214-217)
    energy_oob = 0.5 * grid.oob_k * (dev * dev).sum(-1)
    force_oob = -scaling[..., None] * grid.oob_k * dev

    # scaling-0 atoms give neither grid energy nor restraint
    # (gridForce.cc:40-42)
    live = scaling != 0.0
    zero = torch.zeros((), dtype=dtype, device=pos.device)
    per_atom = torch.where(live, torch.where(inside, energy_in, energy_oob),
                           zero)
    forces = torch.where((live & inside)[..., None], force_in,
                         torch.where((live & ~inside)[..., None], force_oob,
                                     zero))
    return GridEval(per_atom.sum(-1), forces, per_atom)
