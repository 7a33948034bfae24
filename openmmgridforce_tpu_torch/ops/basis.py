"""1-D interpolation basis functions of the value-based methods.

Each family returns a [..., K] tensor of all its basis values at the cell
fraction t. The Hermite families wait for the derivative slice (ROADMAP,
Queue A item 9).
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
