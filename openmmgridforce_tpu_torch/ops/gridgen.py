"""Grid generation: receptor fields sampled on a rectilinear grid.

The values branch of the JAX module: sum the fields of all receptor atoms
at every grid point, tanh-cap the sum, and apply the inverse-power storage
transform when one is configured. The input's device decides the route: a
CUDA float32 run goes through the hand-written kernel
(``ops/cuda_gridgen.py``), a CPU run through its plain twin. Generation
with 27 analytic derivatives waits for the derivative slice (ROADMAP,
Queue A item 8 and kernel K2 in Queue B).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..grid import Grid, InterpolationMethod, InvPowerMode
from ..units import DEFAULT_GRID_CAP, DEFAULT_OOB_K, TWO_POW_ONE_SIXTH
from . import radial
from .chain_rules import tanh_cap_value
from .cuda_gridgen import grid_point_positions, gridgen_values  # noqa: F401

_R_MIN_VALUES = 1e-6      # nm


def _values_at_points(points, grid_type, positions, charges, sigmas,
                      epsilons, grid_cap, lj_convention="rmin"):
    """Capped field values at points [..., 3] from the field laws
    (receptor arrays [A]); the [..., A] pair block is materialised, so
    callers chunk the points."""
    dr = points[..., None, :] - positions          # [..., A, 3]
    r = torch.sqrt((dr * dr).sum(-1)).clamp_min(_R_MIN_VALUES)
    contrib = radial.field_value(r, grid_type, charges, sigmas, epsilons,
                                 lj_convention)
    return tanh_cap_value(contrib.sum(-1), grid_cap)


def receptor_atoms(grid_type, positions, charges, sigmas, epsilons,
                   lj_convention="rmin", dtype=torch.float32, device=None):
    """The kernel's atom table [A, 4]: rows (x, y, z, K), K the per-atom
    field strength computed on the host in float64."""
    pos = np.asarray(positions, np.float64).reshape(-1, 3)
    K = radial.field_strength(grid_type, charges, sigmas, epsilons,
                              lj_convention)
    return torch.as_tensor(np.concatenate([pos, K[:, None]], axis=1),
                           dtype=dtype,
                           device=resolve_device(device)).contiguous()


def generate_grid(counts,
                  spacing,
                  origin,
                  grid_type: str,
                  receptor_positions,
                  charges,
                  sigmas,
                  epsilons,
                  *,
                  compute_derivatives: bool = False,
                  grid_cap: float = DEFAULT_GRID_CAP,
                  inv_power: float = 0.0,
                  inv_power_mode: InvPowerMode = InvPowerMode.NONE,
                  interp_method: InterpolationMethod =
                  InterpolationMethod.TRILINEAR,
                  oob_k: float = DEFAULT_OOB_K,
                  lj_convention: str = "rmin",
                  dtype=torch.float32,
                  device=None) -> Grid:
    """Generate one receptor value grid.

    The per-atom strength K of the chosen grid type and LJ convention is
    computed on the host in float64; the sum over atoms runs on ``device``
    (the CUDA card by default) in ``dtype``.
    """
    device = resolve_device(device)
    if compute_derivatives:
        raise NotImplementedError(
            "generation with 27 analytic derivatives is not ported yet "
            "(ROADMAP: Queue A item 8, kernel K2 in Queue B)")
    if device.type == "cuda" and dtype != torch.float32:
        raise NotImplementedError(
            f"{dtype} grid generation on CUDA is not ported yet; the kernel "
            "is float32 (ROADMAP: float64 on CUDA, Queue A)")
    counts = tuple(int(c) for c in counts)
    atoms = receptor_atoms(grid_type, receptor_positions, charges, sigmas,
                           epsilons, lj_convention, dtype, device)
    vals = gridgen_values(atoms, counts, spacing, origin, grid_type,
                          grid_cap)
    if inv_power != 0.0 and inv_power_mode != InvPowerMode.NONE:
        # values-only storage transform; no 1e-10 dead zone on this side
        sign = torch.where(vals >= 0.0, 1.0, -1.0).to(dtype)
        vals = sign * vals.abs() ** (1.0 / inv_power)
    return Grid(
        vals=vals,
        spacing=torch.tensor(spacing, dtype=dtype, device=device),
        origin=torch.tensor(origin, dtype=dtype, device=device),
        counts=counts,
        interp_method=int(interp_method),
        inv_power_mode=int(inv_power_mode),
        inv_power=float(inv_power),
        grid_cap=float(grid_cap),
        oob_k=float(oob_k),
        grid_type=grid_type,
    )


def auto_scaling_factors(grid_type: str, charges, sigmas, epsilons,
                         convention: str = "rmin"):
    """Per-atom scaling factors (float64 numpy) for a grid type.

    ``convention``: "rmin" gives sqrt(eps) Rmin^k with Rmin = 2^(1/6)
    sigma, consistent with the generated fields; "diameter" gives
    sqrt(eps) (2 sigma)^k, the reference platform's form.
    """
    charges = np.asarray(charges, np.float64)
    sigmas = np.asarray(sigmas, np.float64)
    epsilons = np.asarray(epsilons, np.float64)
    if grid_type == "charge":
        return charges
    if convention == "rmin":
        d = TWO_POW_ONE_SIXTH * sigmas
    elif convention == "diameter":
        d = 2.0 * sigmas
    else:
        raise ValueError(f"unknown convention {convention!r}")
    if grid_type == "ljr":
        return np.sqrt(epsilons) * d ** 6
    if grid_type == "lja":
        return np.sqrt(epsilons) * d ** 3
    raise ValueError(f"unknown grid type {grid_type!r}")
