"""Grid container: one receptor field grid on tensors.

Layout: ``vals`` is [nx, ny, nz] in C order (z fastest), the flat index of
point (i, j, k) being ``i*ny*nz + j*nz + k``; ``derivs`` is
[nx, ny, nz, 27], derivative-minor, in cell-fractional units (see
``ops/derivatives27.py``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from .units import DEFAULT_GRID_CAP, DEFAULT_OOB_K


class InvPowerMode(enum.IntEnum):
    """Inverse-power smoothing transform modes."""

    NONE = 0     # grid stores raw values, no transform
    RUNTIME = 1  # grid stores raw values; eval transforms the stencil to
                 # G^(1/n), interpolates, then back-transforms (.)^n
    STORED = 2   # grid stores G^(1/n); eval back-transforms (.)^n


class InterpolationMethod(enum.IntEnum):
    """Interpolation methods."""

    TRILINEAR = 0
    BSPLINE = 1     # cubic B-spline, 4x4x4 stencil (smoothing, not exact)
    TRICUBIC = 2    # tricubic Hermite, needs 8 derivatives
    TRIQUINTIC = 3  # triquintic Hermite, needs all 27 derivatives


@dataclasses.dataclass(frozen=True)
class Grid:
    """One receptor field grid plus its evaluation configuration."""

    vals: torch.Tensor                 # [nx, ny, nz]
    spacing: torch.Tensor              # [3] nm
    origin: torch.Tensor               # [3] nm
    counts: tuple = (0, 0, 0)
    interp_method: int = int(InterpolationMethod.TRILINEAR)
    inv_power_mode: int = int(InvPowerMode.NONE)
    inv_power: float = 0.0
    grid_cap: float = DEFAULT_GRID_CAP
    oob_k: float = DEFAULT_OOB_K
    grid_type: str = ""
    derivs: Optional[torch.Tensor] = None   # [nx, ny, nz, 27] or None
