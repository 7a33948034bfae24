"""Finite-difference 27-derivative computation from a value grid, on
tensors (the port's copy of the JAX module).

Vectorized re-design of the reference CPU path
(ReferenceGridForceKernels.cpp:281-463 computeDerivativesAtPoint +
:546-643 storage loop): all mixed partials up to order 2 per axis from
centered stencils (one-sided at boundaries for the first and pure-second
derivatives; clamped-centered for mixed terms), evaluated for every grid
point at once with shifted padded views — one fused elementwise program
instead of a triple loop of 27-stencil gathers.

Storage convention: cell-fractional (physical derivative times
spacing**order), consistent with the analytic generation path and the
evaluation kernels (gridGeneration.cu:143-185). NOTE the reference
platform instead DIVIDES by spacing powers and compensates inside its own
triquintic branch (SURVEY quirks Q12) — a self-consistent pair we do not
reproduce; the CUDA convention is this engine's parity target.

Overlap handling mirrors the reference (:610-630): where the value is
within 0.1% of the cap, first derivatives are clamped to +-cap and all
higher derivatives zeroed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .derivatives27 import DERIV_ORDERS


def _shifted(P, dx, dy, dz, counts):
    """View of the edge-padded array shifted by (dx, dy, dz) in [-2, 2]."""
    nx, ny, nz = counts
    return P[2 + dx:2 + dx + nx, 2 + dy:2 + dy + ny, 2 + dz:2 + dz + nz]


def fd_derivatives27(vals, spacing, grid_cap=None):
    """All 27 derivatives of a value grid by finite differences.

    Args:
      vals: [nx, ny, nz] (capped) grid values, a tensor on any device.
      spacing: (dx, dy, dz).
      grid_cap: optional U_max for overlap-region clamping.

    Returns [nx, ny, nz, 27] cell-fractional derivatives (slot 0 = vals).
    """
    vals = torch.as_tensor(vals)
    counts = tuple(vals.shape)
    hx, hy, hz = (float(s) for s in spacing)
    P = F.pad(vals[None, None], (2,) * 6, mode="replicate")[0, 0]

    def g(dx, dy, dz):
        return _shifted(P, dx, dy, dz, counts)

    f = vals

    def first_axis(axis, h):
        """Centered with one-sided boundary planes (reference :304-326)."""
        e = [0, 0, 0]
        e[axis] = 1
        centered = (g(*e) - g(*[-v for v in e])) / (2.0 * h)
        fwd = (g(*e) - f) / h
        e2 = [0, 0, 0]
        e2[axis] = -1
        bwd = (f - g(*e2)) / h
        return _by_plane(axis, counts, fwd, bwd, centered)

    def second_axis(axis, h):
        """Pure second: centered, one-sided at boundaries (:328-352)."""
        e1 = [0, 0, 0]
        e1[axis] = 1
        e2 = [0, 0, 0]
        e2[axis] = 2
        em1 = [0, 0, 0]
        em1[axis] = -1
        em2 = [0, 0, 0]
        em2[axis] = -2
        centered = (g(*e1) - 2.0 * f + g(*em1)) / (h * h)
        fwd = (g(*e2) - 2.0 * g(*e1) + f) / (h * h)
        bwd = (f - 2.0 * g(*em1) + g(*em2)) / (h * h)
        return _by_plane(axis, counts, fwd, bwd, centered)

    fx = first_axis(0, hx)
    fy = first_axis(1, hy)
    fz = first_axis(2, hz)
    fxx = second_axis(0, hx)
    fyy = second_axis(1, hy)
    fzz = second_axis(2, hz)

    # mixed derivatives: clamped-centered stencils exactly as the
    # reference's getVal-based formulas (:354-450); with edge padding the
    # clamped reads fall out of the shifted views
    def c2(ax_a, ax_b, ha, hb):
        ea = np.eye(3, dtype=int)[ax_a]
        eb = np.eye(3, dtype=int)[ax_b]
        return (g(*(ea + eb)) - g(*(-ea + eb)) - g(*(ea - eb))
                + g(*(-ea - eb))) / (4.0 * ha * hb)

    fxy = c2(0, 1, hx, hy)
    fxz = c2(0, 2, hx, hz)
    fyz = c2(1, 2, hy, hz)

    ex, ey, ez = (np.eye(3, dtype=int)[i] for i in range(3))

    def d2_1(ax2, ax1, h2, h1):
        """d^3/d(ax2)^2 d(ax1): second in ax2, centered first in ax1."""
        a = np.eye(3, dtype=int)[ax2]
        b = np.eye(3, dtype=int)[ax1]
        return (g(*(a + b)) - 2.0 * g(*b) + g(*(-a + b))
                - g(*(a - b)) + 2.0 * g(*(-b)) - g(*(-a - b))) / (
            2.0 * h2 * h2 * h1)

    fxxy = d2_1(0, 1, hx, hy)
    fxxz = d2_1(0, 2, hx, hz)
    fxyy = d2_1(1, 0, hy, hx)
    fyyz = d2_1(1, 2, hy, hz)
    fxzz = d2_1(2, 0, hz, hx)
    fyzz = d2_1(2, 1, hz, hy)

    fxyz = (g(1, 1, 1) - g(-1, 1, 1) - g(1, -1, 1) + g(-1, -1, 1)
            - g(1, 1, -1) + g(-1, 1, -1) + g(1, -1, -1)
            - g(-1, -1, -1)) / (8.0 * hx * hy * hz)

    def d2_2(ax_a, ax_b, ha, hb):
        """d^4/d(ax_a)^2 d(ax_b)^2."""
        a = np.eye(3, dtype=int)[ax_a]
        b = np.eye(3, dtype=int)[ax_b]
        return (g(*(a + b)) - 2.0 * g(*b) + g(*(-a + b))
                - 2.0 * g(*a) + 4.0 * f - 2.0 * g(*(-a))
                + g(*(a - b)) - 2.0 * g(*(-b)) + g(*(-a - b))) / (
            ha * ha * hb * hb)

    fxxyy = d2_2(0, 1, hx, hy)
    fxxzz = d2_2(0, 2, hx, hz)
    fyyzz = d2_2(1, 2, hy, hz)

    def d2_1_1(ax2, ax1a, ax1b, h2, h1a, h1b):
        """d^4/d(ax2)^2 d(ax1a) d(ax1b)."""
        a = np.eye(3, dtype=int)[ax2]
        b = np.eye(3, dtype=int)[ax1a]
        c = np.eye(3, dtype=int)[ax1b]
        return (g(*(a + b + c)) - 2.0 * g(*(b + c)) + g(*(-a + b + c))
                - g(*(a - b + c)) + 2.0 * g(*(-b + c)) - g(*(-a - b + c))
                - g(*(a + b - c)) + 2.0 * g(*(b - c)) - g(*(-a + b - c))
                + g(*(a - b - c)) - 2.0 * g(*(-b - c))
                + g(*(-a - b - c))) / (4.0 * h2 * h2 * h1a * h1b)

    fxxyz = d2_1_1(0, 1, 2, hx, hy, hz)
    fxyyz = d2_1_1(1, 0, 2, hy, hx, hz)
    fxyzz = d2_1_1(2, 0, 1, hz, hx, hy)

    def d2_2_1(ax2a, ax2b, ax1, h2a, h2b, h1):
        """d^5/d(ax2a)^2 d(ax2b)^2 d(ax1)."""
        a = np.eye(3, dtype=int)[ax2a]
        b = np.eye(3, dtype=int)[ax2b]
        c = np.eye(3, dtype=int)[ax1]

        def plane(sc, cc):
            return sc * (g(*(a + b + cc)) - 2.0 * g(*(b + cc))
                         + g(*(-a + b + cc))
                         - 2.0 * g(*(a + cc)) + 4.0 * g(*cc)
                         - 2.0 * g(*(-a + cc))
                         + g(*(a - b + cc)) - 2.0 * g(*(-b + cc))
                         + g(*(-a - b + cc)))

        return (plane(1.0, c) + plane(-1.0, -c)) / (
            2.0 * h2a * h2a * h2b * h2b * h1)

    fxxyyz = d2_2_1(0, 1, 2, hx, hy, hz)
    fxxyzz = d2_2_1(0, 2, 1, hx, hz, hy)
    fxyyzz = d2_2_1(1, 2, 0, hy, hz, hx)

    # sixth derivative d^6/dx^2 dy^2 dz^2: tensor product of three
    # 1-D second-difference stencils [1, -2, 1]
    def sixth():
        acc = torch.zeros_like(f)
        w = {-1: 1.0, 0: -2.0, 1: 1.0}
        for sx_, wx_ in w.items():
            for sy_, wy_ in w.items():
                for sz_, wz_ in w.items():
                    acc = acc + wx_ * wy_ * wz_ * g(sx_, sy_, sz_)
        return acc / (hx * hx * hy * hy * hz * hz)

    fxxyyzz = sixth()

    phys = {
        (0, 0, 0): f,
        (1, 0, 0): fx, (0, 1, 0): fy, (0, 0, 1): fz,
        (2, 0, 0): fxx, (1, 1, 0): fxy, (1, 0, 1): fxz,
        (0, 2, 0): fyy, (0, 1, 1): fyz, (0, 0, 2): fzz,
        (2, 1, 0): fxxy, (2, 0, 1): fxxz, (1, 2, 0): fxyy,
        (1, 1, 1): fxyz, (0, 2, 1): fyyz, (1, 0, 2): fxzz,
        (0, 1, 2): fyzz,
        (2, 2, 0): fxxyy, (2, 0, 2): fxxzz, (0, 2, 2): fyyzz,
        (2, 1, 1): fxxyz, (1, 2, 1): fxyyz, (1, 1, 2): fxyzz,
        (2, 2, 1): fxxyyz, (2, 1, 2): fxxyzz, (1, 2, 2): fxyyzz,
        (2, 2, 2): fxxyyzz,
    }

    out = []
    for (a, b, c) in DERIV_ORDERS:
        scale = hx ** a * hy ** b * hz ** c
        out.append(phys[(a, b, c)] * scale)
    D = torch.stack(out, dim=-1)

    if grid_cap is not None:
        overlap = (vals >= 0.999 * grid_cap)[..., None]
        order = torch.as_tensor([sum(o) for o in DERIV_ORDERS],
                                device=D.device)
        clamped = D.clamp(-grid_cap, grid_cap)
        zero = torch.zeros((), dtype=D.dtype, device=D.device)
        D = torch.where(overlap,
                        torch.where(order == 1, clamped,
                                    torch.where(order == 0, D, zero)),
                        D)
    return D


def _by_plane(axis, counts, first, last, inner):
    """``first`` on the axis's first plane, ``last`` on its last, ``inner``
    elsewhere."""
    idx = torch.arange(counts[axis], device=inner.device)
    shape = [1, 1, 1]
    shape[axis] = counts[axis]
    idx = idx.reshape(shape)
    return torch.where(idx == 0, first,
                       torch.where(idx == counts[axis] - 1, last, inner))
