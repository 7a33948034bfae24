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

    @property
    def has_derivatives(self) -> bool:
        return self.derivs is not None

    @property
    def num_points(self) -> int:
        nx, ny, nz = self.counts
        return nx * ny * nz

    def with_(self, **kwargs) -> "Grid":
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **kwargs)


def grid_from_numpy(vals, spacing, origin=(0.0, 0.0, 0.0), derivs=None,
                    interp_method=InterpolationMethod.TRILINEAR,
                    inv_power_mode=InvPowerMode.NONE, inv_power=0.0,
                    grid_cap=DEFAULT_GRID_CAP, oob_k=DEFAULT_OOB_K,
                    grid_type="", dtype=None, device=None) -> Grid:
    """A Grid from array-likes, as the JAX package's ``Grid.create`` builds
    one: ``vals`` [nx, ny, nz]; ``derivs`` [27, nx, ny, nz] (the file
    layout) or [nx, ny, nz, 27]; the dtype is that of ``vals`` when it is
    float32 or float64 (else float32) unless given. On ``device``, the
    CUDA card unless ``device="cpu"``."""
    import numpy as np

    from .device import resolve_device

    device = resolve_device(device)
    vals = np.asarray(vals)
    if vals.ndim != 3:
        raise ValueError(f"vals must be 3-D, got shape {vals.shape}")
    counts = tuple(int(c) for c in vals.shape)
    if dtype is None:
        dtype = (torch.float64 if vals.dtype == np.float64
                 else torch.float32)
    d = None
    if derivs is not None:
        derivs = np.asarray(derivs)
        if derivs.ndim == 4 and derivs.shape[0] == 27:
            derivs = np.moveaxis(derivs, 0, -1)
        if derivs.shape != counts + (27,):
            raise ValueError(f"derivs shape {derivs.shape} does not match "
                             f"grid {counts} (+27)")
        d = torch.as_tensor(np.ascontiguousarray(derivs), dtype=dtype,
                            device=device)
    return Grid(vals=torch.as_tensor(vals, dtype=dtype, device=device),
                derivs=d,
                spacing=torch.as_tensor(np.asarray(spacing, np.float64),
                                        dtype=dtype, device=device),
                origin=torch.as_tensor(np.asarray(origin, np.float64),
                                       dtype=dtype, device=device),
                counts=counts, interp_method=int(interp_method),
                inv_power_mode=int(inv_power_mode),
                inv_power=float(inv_power), grid_cap=float(grid_cap),
                oob_k=float(oob_k), grid_type=grid_type)
