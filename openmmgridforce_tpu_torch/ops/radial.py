"""Radial field laws of the three receptor grid types (the value half).

  charge: U = k q / r
  ljr:    U = sqrt(eps) Rmin^6 / r^12,  Rmin = 2^(1/6) sigma
  lja:    U = -2 sqrt(eps) Rmin^3 / r^6

``lj_convention="diameter"`` replaces Rmin with 2 sigma (the reference
platform's form). The derivative tables of the JAX module are not ported
yet (ROADMAP, Queue A item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from ..units import COULOMB_CONST, TWO_POW_ONE_SIXTH

GRID_TYPE_CODES = {"charge": 0, "ljr": 1, "lja": 2}


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
