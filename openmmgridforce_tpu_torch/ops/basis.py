"""1-D interpolation basis functions.

Each family returns a tensor of all its basis values at the cell fraction
t, so it vectorises over atoms:

  * trilinear (2 functions) and cubic B-spline (4 functions): [..., K];
  * cubic Hermite (h00, h10, h01, h11), the tricubic building block, and
    quintic Hermite (6 functions, C2), the triquintic one: [..., M, 2],
    indexed by (derivative order m, side s), with
    H[m][s]^(k)(side j) = delta_km delta_sj.
"""

from __future__ import annotations

import torch


def trilinear_weights(t):
    """The two linear weights (1 - t, t). Returns [..., 2]."""
    return torch.stack([1.0 - t, t], dim=-1)


def bspline_weights(t):
    """All four cubic B-spline basis values at fraction t. Returns [..., 4]."""
    omt = 1.0 - t
    b0 = omt * omt * omt / 6.0
    b1 = (3.0 * t * t * t - 6.0 * t * t + 4.0) / 6.0
    b2 = (-3.0 * t * t * t + 3.0 * t * t + 3.0 * t + 1.0) / 6.0
    b3 = t * t * t / 6.0
    return torch.stack([b0, b1, b2, b3], dim=-1)


def bspline_derivs(t):
    """Derivatives of the four cubic B-spline basis functions. [..., 4]."""
    omt = 1.0 - t
    d0 = -omt * omt / 2.0
    d1 = (3.0 * t * t - 4.0 * t) / 2.0
    d2 = (-3.0 * t * t + 2.0 * t + 1.0) / 2.0
    d3 = t * t / 2.0
    return torch.stack([d0, d1, d2, d3], dim=-1)


def _by_order_and_side(*pairs):
    """[(side 0, side 1), ...] per derivative order -> [..., M, 2]."""
    return torch.stack([torch.stack(p, dim=-1) for p in pairs], dim=-2)


def hermite3_weights(t):
    """Cubic Hermite basis values, shape [..., 2, 2] indexed [m, side]."""
    h00 = (1.0 + 2.0 * t) * (1.0 - t) * (1.0 - t)
    h01 = t * t * (3.0 - 2.0 * t)
    h10 = t * (1.0 - t) * (1.0 - t)
    h11 = t * t * (t - 1.0)
    return _by_order_and_side((h00, h01), (h10, h11))


def hermite3_derivs(t):
    """d/dt of the cubic Hermite basis, shape [..., 2, 2] indexed [m, side]."""
    dh00 = 6.0 * t * t - 6.0 * t
    dh01 = -6.0 * t * t + 6.0 * t
    dh10 = 3.0 * t * t - 4.0 * t + 1.0
    dh11 = 3.0 * t * t - 2.0 * t
    return _by_order_and_side((dh00, dh01), (dh10, dh11))


def hermite5_weights(t):
    """Quintic Hermite basis values, shape [..., 3, 2] indexed [m, side]."""
    t2 = t * t
    t3 = t2 * t
    t4 = t3 * t
    t5 = t4 * t
    h00 = 1.0 - 10.0 * t3 + 15.0 * t4 - 6.0 * t5
    h01 = 10.0 * t3 - 15.0 * t4 + 6.0 * t5
    h10 = t - 6.0 * t3 + 8.0 * t4 - 3.0 * t5
    h11 = -4.0 * t3 + 7.0 * t4 - 3.0 * t5
    h20 = 0.5 * t2 - 1.5 * t3 + 1.5 * t4 - 0.5 * t5
    h21 = 0.5 * t3 - t4 + 0.5 * t5
    return _by_order_and_side((h00, h01), (h10, h11), (h20, h21))


def hermite5_derivs(t):
    """d/dt of the quintic Hermite basis, shape [..., 3, 2]."""
    t2 = t * t
    t3 = t2 * t
    t4 = t3 * t
    dh00 = -30.0 * t2 + 60.0 * t3 - 30.0 * t4
    dh01 = 30.0 * t2 - 60.0 * t3 + 30.0 * t4
    dh10 = 1.0 - 18.0 * t2 + 32.0 * t3 - 15.0 * t4
    dh11 = -12.0 * t2 + 28.0 * t3 - 15.0 * t4
    dh20 = t - 4.5 * t2 + 6.0 * t3 - 2.5 * t4
    dh21 = 1.5 * t2 - 4.0 * t3 + 2.5 * t4
    return _by_order_and_side((dh00, dh01), (dh10, dh11), (dh20, dh21))
