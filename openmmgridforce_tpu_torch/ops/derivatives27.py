"""The canonical 27-derivative layout for Hermite grids.

A triquintic-Hermite grid stores, at every grid point, all mixed partial
derivatives d^(a+b+c) f / dx^a dy^b dz^c with a, b, c in {0, 1, 2}
(27 of them, including the value itself). The storage order mirrors the
reference's RASPA3-compatible order (reference
platforms/cuda/src/kernels/gridGeneration.cu:149-195):

  index  derivative (a, b, c) = orders in (x, y, z)
  0      f        (0,0,0)
  1-3    x, y, z
  4-9    xx, xy, xz, yy, yz, zz
  10-16  xxy, xxz, xyy, xyz, yyz, xzz, yzz
  17-22  xxyy, xxzz, yyzz, xxyz, xyyz, xyzz
  23-25  xxyyz, xxyzz, xyyzz
  26     xxyyzz

Derivatives are stored pre-scaled to cell-fractional coordinates: the value
at index d is (d^|m| f / ds^m) where s = x / spacing, i.e. the physical
derivative multiplied by spacing**order per axis
(gridGeneration.cu:143-185). Evaluation therefore divides polynomial
gradients by the spacing once at the end.
"""

from __future__ import annotations

import numpy as np

# (a, b, c): differentiation orders along (x, y, z) for each of the 27 slots.
DERIV_ORDERS: tuple[tuple[int, int, int], ...] = (
    (0, 0, 0),
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
    (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (0, 2, 1), (1, 0, 2), (0, 1, 2),
    (2, 2, 0), (2, 0, 2), (0, 2, 2), (2, 1, 1), (1, 2, 1), (1, 1, 2),
    (2, 2, 1), (2, 1, 2), (1, 2, 2),
    (2, 2, 2),
)

N_DERIVS = 27

# Map from (a, b, c) to the storage index.
ORDER_TO_INDEX: dict[tuple[int, int, int], int] = {
    o: i for i, o in enumerate(DERIV_ORDERS)
}

# The 8 derivatives needed by tricubic (Lekien-Marsden) interpolation, in its
# own order {f, fx, fy, fz, fxy, fxz, fyz, fxyz}, as indices into the
# 27-derivative layout (reference kernels/gridForce.cu:178 derivMap).
TRICUBIC_DERIV_MAP: tuple[int, ...] = tuple(
    ORDER_TO_INDEX[o]
    for o in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
              (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1))
)


def spacing_scale_factors(spacing) -> np.ndarray:
    """Per-slot multipliers converting physical derivatives to
    cell-fractional storage: prod(spacing[axis]**order[axis])."""
    dx, dy, dz = float(spacing[0]), float(spacing[1]), float(spacing[2])
    return np.array(
        [dx ** a * dy ** b * dz ** c for (a, b, c) in DERIV_ORDERS],
        dtype=np.float64,
    )
