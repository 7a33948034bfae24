"""Radial field laws of the three receptor grid types, their radial
derivatives and the radial-to-Cartesian tensor conversion.

For a radially symmetric field U(r), all Cartesian mixed partials up to
order 6 follow from the radial derivatives d^n U / dr^n and the direction
cosines by the classical cascade formulas for isotropic functions.

  charge: U = k q / r
  ljr:    U = sqrt(eps) Rmin^6 / r^12,  Rmin = 2^(1/6) sigma
  lja:    U = -2 sqrt(eps) Rmin^3 / r^6

``lj_convention="diameter"`` replaces Rmin with 2 sigma (the reference
platform's form).
"""

from __future__ import annotations

import numpy as np
import torch

from ..units import COULOMB_CONST, TWO_POW_ONE_SIXTH

GRID_TYPE_CODES = {"charge": 0, "ljr": 1, "lja": 2}

# Falling-factorial magnitudes of d^n/dr^n r^-m for m = 1, 6, 12:
# coefficient_n = (-1)^n * m (m+1) ... (m+n-1)
_COEF_M1 = (1.0, -1.0, 2.0, -6.0, 24.0, -120.0, 720.0)
_COEF_M6 = (1.0, -6.0, 42.0, -336.0, 3024.0, -30240.0, 332640.0)
_COEF_M12 = (1.0, -12.0, 156.0, -2184.0, 32760.0, -524160.0, 8910720.0)

# grid type -> (power m of K / r^m, its derivative coefficients)
FIELD_POWERS = {"charge": (1, _COEF_M1), "ljr": (12, _COEF_M12),
                "lja": (6, _COEF_M6)}


def _lj_size(sigma, lj_convention: str):
    """LJ size parameter: Rmin = 2^(1/6) sigma, or the diameter 2 sigma."""
    if lj_convention == "rmin":
        return TWO_POW_ONE_SIXTH * sigma
    if lj_convention == "diameter":
        return 2.0 * sigma
    raise ValueError(f"unknown lj convention {lj_convention!r}")


def field_value(r, grid_type: str, charge, sigma, epsilon,
                lj_convention: str = "rmin"):
    """Raw (uncapped) field value at distance r (tensors broadcast)."""
    if grid_type == "charge":
        return COULOMB_CONST * charge / r
    if grid_type == "ljr":
        d = _lj_size(sigma, lj_convention)
        return torch.sqrt(epsilon) * d ** 6 / r ** 12
    if grid_type == "lja":
        d = _lj_size(sigma, lj_convention)
        return -2.0 * torch.sqrt(epsilon) * d ** 3 / r ** 6
    raise ValueError(f"unknown grid type {grid_type!r}")


def field_strength(grid_type: str, charges, sigmas, epsilons,
                   lj_convention: str = "rmin") -> np.ndarray:
    """Per-atom strength K of the field K / r^p, in float64 on the host:
    k q (p = 1), sqrt(eps) Rmin^6 (p = 12) or -2 sqrt(eps) Rmin^3 (p = 6)."""
    q = np.asarray(charges, np.float64)
    sig = np.asarray(sigmas, np.float64)
    eps = np.asarray(epsilons, np.float64)
    if grid_type == "charge":
        return COULOMB_CONST * q
    if grid_type == "ljr":
        return np.sqrt(eps) * _lj_size(sig, lj_convention) ** 6
    if grid_type == "lja":
        return -2.0 * np.sqrt(eps) * _lj_size(sig, lj_convention) ** 3
    raise ValueError(f"unknown grid type {grid_type!r}")


def radial_derivatives(r2, grid_type: str, charge, sigma, epsilon,
                       lj_convention: str = "rmin"):
    """[..., 7] radial derivatives [U, U', ..., U^(6)] of the field of one
    receptor atom at squared distance r2 (already clamped by the caller)."""
    inv_r = 1.0 / torch.sqrt(r2)
    if grid_type == "charge":
        K = COULOMB_CONST * charge
    elif grid_type == "ljr":
        K = torch.sqrt(epsilon) * _lj_size(sigma, lj_convention) ** 6
    elif grid_type == "lja":
        K = -2.0 * torch.sqrt(epsilon) * _lj_size(sigma, lj_convention) ** 3
    else:
        raise ValueError(f"unknown grid type {grid_type!r}")
    m, coefs = FIELD_POWERS[grid_type]
    p = K * inv_r ** m  # U
    out = []
    for n in range(7):
        out.append(coefs[n] * p)
        p = p * inv_r
    return torch.stack(out, dim=-1)


def cartesian_terms(dx, dy, dz, inv_r, i2, i3, i4, i5, U, dU, d2U, d3U, d4U,
                    d5U, d6U):
    """The 27 Cartesian mixed partials (canonical order, orders <= 2 per
    axis) of a radial field, as a list of tensors, from the displacement
    components, 1/r and its powers up to the fifth, and the radial
    derivatives."""
    nx, ny, nz = dx * inv_r, dy * inv_r, dz * inv_r
    nx2, ny2, nz2 = nx * nx, ny * ny, nz * nz

    # Cascade coefficients: d^k U along ni..nj decomposes into products of
    # direction cosines and Kronecker deltas with these radial combinations.
    A2 = d2U - dU * inv_r
    A3 = d3U - 3.0 * d2U * inv_r + 3.0 * dU * i2
    B3 = d2U * inv_r - dU * i2
    A4 = d4U - 6.0 * d3U * inv_r + 15.0 * d2U * i2 - 15.0 * dU * i3
    B4 = d3U * inv_r - 3.0 * d2U * i2 + 3.0 * dU * i3
    C4 = d2U * i2 - dU * i3
    A5 = (d5U - 10.0 * d4U * inv_r + 45.0 * d3U * i2
          - 105.0 * d2U * i3 + 105.0 * dU * i4)
    B5 = d4U * inv_r - 6.0 * d3U * i2 + 15.0 * d2U * i3 - 15.0 * dU * i4
    C5 = d3U * i2 - 3.0 * d2U * i3 + 3.0 * dU * i4
    A6 = (d6U - 15.0 * d5U * inv_r + 105.0 * d4U * i2 - 420.0 * d3U * i3
          + 945.0 * d2U * i4 - 945.0 * dU * i5)
    B6 = (d5U * inv_r - 10.0 * d4U * i2 + 45.0 * d3U * i3
          - 105.0 * d2U * i4 + 105.0 * dU * i5)
    C6 = d4U * i2 - 6.0 * d3U * i3 + 15.0 * d2U * i4 - 15.0 * dU * i5
    D6 = d3U * i3 - 3.0 * d2U * i4 + 3.0 * dU * i5

    dUr = dU * inv_r
    return [
        U,                                # 0 f
        dU * nx, dU * ny, dU * nz,        # 1-3
        A2 * nx2 + dUr,                   # 4 xx
        A2 * nx * ny,                     # 5 xy
        A2 * nx * nz,                     # 6 xz
        A2 * ny2 + dUr,                   # 7 yy
        A2 * ny * nz,                     # 8 yz
        A2 * nz2 + dUr,                   # 9 zz
        A3 * nx2 * ny + B3 * ny,          # 10 xxy
        A3 * nx2 * nz + B3 * nz,          # 11 xxz
        A3 * nx * ny2 + B3 * nx,          # 12 xyy
        A3 * nx * ny * nz,                # 13 xyz
        A3 * ny2 * nz + B3 * nz,          # 14 yyz
        A3 * nx * nz2 + B3 * nx,          # 15 xzz
        A3 * ny * nz2 + B3 * ny,          # 16 yzz
        A4 * nx2 * ny2 + B4 * (nx2 + ny2) + C4,   # 17 xxyy
        A4 * nx2 * nz2 + B4 * (nx2 + nz2) + C4,   # 18 xxzz
        A4 * ny2 * nz2 + B4 * (ny2 + nz2) + C4,   # 19 yyzz
        A4 * nx2 * ny * nz + B4 * ny * nz,        # 20 xxyz
        A4 * nx * ny2 * nz + B4 * nx * nz,        # 21 xyyz
        A4 * nx * ny * nz2 + B4 * nx * ny,        # 22 xyzz
        A5 * nx2 * ny2 * nz + B5 * (nx2 + ny2) * nz + C5 * nz,       # 23
        A5 * nx2 * ny * nz2 + B5 * (ny * nz2 + nx2 * ny) + C5 * ny,  # 24
        A5 * nx * ny2 * nz2 + B5 * (nx * nz2 + nx * ny2) + C5 * nx,  # 25
        (A6 * nx2 * ny2 * nz2
         + B6 * (nx2 * ny2 + nx2 * nz2 + ny2 * nz2)
         + C6 * (nx2 + ny2 + nz2) + D6),          # 26 xxyyzz
    ]


def radial_to_cartesian(dr, rad, reduce_axis=None):
    """Convert radial derivatives to the 27 Cartesian derivatives.

    Args:
      dr:  [..., 3] displacement grid_point - atom_position (nm).
      rad: [..., 7] radial derivatives [U, dU, d2U, ..., d6U].
      reduce_axis: if set, sum each derivative component over this axis
        before stacking (-1 reduces over an atom axis), so the
        [..., atoms, 27] tensor is never materialised.

    Returns [..., 27] in the canonical derivative order (with
    ``reduce_axis`` removed when given).
    """
    inv_r = 1.0 / torch.sqrt((dr * dr).sum(-1))
    i2 = inv_r * inv_r
    i4 = i2 * i2
    terms = cartesian_terms(dr[..., 0], dr[..., 1], dr[..., 2], inv_r, i2,
                            i2 * inv_r, i4, i4 * inv_r, *rad.unbind(-1))
    if reduce_axis is not None:
        terms = [t.sum(dim=reduce_axis) for t in terms]
    return torch.stack(terms, dim=-1)
