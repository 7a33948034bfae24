"""Receptor fields at grid points, worked out from the receptor's atoms.

The configuration's grid semantics, written here from their definitions:

  strengths  charge: k q / r; ljr: sqrt(eps) Rmin^6 / r^12; lja:
             -2 sqrt(eps) Rmin^3 / r^6, Rmin = 2^(1/6) sigma;
  values     U = sum over receptor atoms, r^2 >= 1e-12 nm^2, then the cap
             V = cap tanh(U / cap) (B-spline grids);
  derivatives  the 27 mixed partials of U of order <= 2 an axis, r^2 >=
             4e-4 nm^2 (the clamped r^2 in the radial factors, the
             displacement as it is), then the cap's exact chain rule where
             U >= 0.1 cap (below it the derivatives pass unchanged), then
             each scaled by spacing^order into cell-fractional units
             (triquintic grids).

The derivatives of g(r^2) come from the operator form: along an axis,
d/dx g = 2 dx g' and d^2/dx^2 g = 2 g' + 4 dx^2 g'', so a slot of orders
(a, b, c) is a sum of terms const dx^i dy^j dz^k g^(n)(r^2). The cap's
chain rule composes truncated Taylor series in (x, y, z) with at most the
second power of each variable.
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

COULOMB = 138.935456          # kJ nm / (mol e^2)
RMIN_PER_SIGMA = 2.0 ** (1.0 / 6.0)
POWERS = {"charge": 1, "ljr": 12, "lja": 6}
R2_MIN_VALUES = 1e-12
R2_MIN_DERIVS = 4e-4
# [P, A] pair elements a chunk of points holds
_PAIR_CHUNK = 1 << 24


def strengths(grid_type, charges, sigmas, epsilons) -> np.ndarray:
    """K of each receptor atom's field K / r^p."""
    q, sig, eps = (np.asarray(a, np.float64)
                   for a in (charges, sigmas, epsilons))
    if grid_type == "charge":
        return COULOMB * q
    rmin = RMIN_PER_SIGMA * sig
    if grid_type == "ljr":
        return np.sqrt(eps) * rmin ** 6
    if grid_type == "lja":
        return -2.0 * np.sqrt(eps) * rmin ** 3
    raise ValueError(grid_type)


def scalings(grid_type, charges, sigmas, epsilons) -> np.ndarray:
    """The ligand atoms' coupling to a grid: q, sqrt(eps) Rmin^6 or
    sqrt(eps) Rmin^3."""
    q, sig, eps = (np.asarray(a, np.float64)
                   for a in (charges, sigmas, epsilons))
    if grid_type == "charge":
        return q
    rmin = RMIN_PER_SIGMA * sig
    return np.sqrt(eps) * rmin ** (6 if grid_type == "ljr" else 3)


def point_coords(flat, counts, origin, spacing, dtype):
    """Coordinates [..., 3] of grid points by flat index (z fastest)."""
    _, ny, nz = counts
    ijk = torch.stack([flat // (ny * nz), (flat // nz) % ny, flat % nz], -1)
    o = torch.as_tensor(origin, dtype=dtype, device=flat.device)
    h = torch.as_tensor(spacing, dtype=dtype, device=flat.device)
    return o + ijk.to(dtype) * h


def _chunks(n_points, n_atoms):
    step = max(1, _PAIR_CHUNK // max(1, n_atoms))
    return range(0, n_points, step), step


def capped_values(points, atoms, K, grid_type, cap, ar):
    """V = cap tanh(sum_a K_a / r^p / cap) at points [P, 3]."""
    p = POWERS[grid_type]
    out = torch.empty(points.shape[0], dtype=ar.dtype, device=points.device)
    Kr = ar.rnd(K)
    starts, step = _chunks(points.shape[0], atoms.shape[0])
    for lo in starts:
        d = points[lo:lo + step, None, :] - atoms[None]
        r2 = (d * d).sum(-1).clamp_min(R2_MIN_VALUES)
        u = (Kr * ar.rnd(r2 ** (-0.5 * p))).sum(-1)
        out[lo:lo + step] = cap * torch.tanh(u / cap)
    return out


@functools.cache
def _slot_terms():
    """For each slot (a, b, c) of orders <= 2 an axis, the terms of its
    derivative of g(r^2): (n, const, i, j, k) for const dx^i dy^j dz^k
    g^(n)."""
    axis = {0: [(0, 1.0, 0)], 1: [(1, 2.0, 1)],
            2: [(1, 2.0, 0), (2, 4.0, 2)]}
    out = {}
    for a, b, c in itertools.product(range(3), repeat=3):
        terms = []
        for (nx, cx, ex), (ny, cy, ey), (nz, cz, ez) in itertools.product(
                axis[a], axis[b], axis[c]):
            terms.append((nx + ny + nz, cx * cy * cz, ex, ey, ez))
        out[(a, b, c)] = terms
    return out


def raw_derivatives(points, atoms, K, grid_type, ar):
    """The 27 mixed partials [P, 3, 3, 3] (indexed by the orders along x,
    y, z) of sum_a K_a / r^p at points [P, 3], r^2 clamped at 4e-4."""
    half = 0.5 * POWERS[grid_type]
    # g(s) = s^-half: g^(n)(s) = c_n s^(-half - n)
    c = [math.prod(-half - j for j in range(n)) for n in range(7)]
    out = torch.empty((points.shape[0], 3, 3, 3), dtype=ar.dtype,
                      device=points.device)
    Kr = ar.rnd(K)
    starts, step = _chunks(points.shape[0], atoms.shape[0])
    for lo in starts:
        d = points[lo:lo + step, None, :] - atoms[None]
        dx, dy, dz = d.unbind(-1)
        s = (d * d).sum(-1).clamp_min(R2_MIN_DERIVS)
        inv_s = 1.0 / s
        g = [s ** (-half)]
        for n in range(1, 7):
            g.append(g[-1] * inv_s)
        pw = [[torch.ones_like(dx), dx, dx * dx],
              [torch.ones_like(dy), dy, dy * dy],
              [torch.ones_like(dz), dz, dz * dz]]
        for (a, b, cc), terms in _slot_terms().items():
            acc = 0.0
            for n, const, i, j, k in terms:
                acc = acc + (const * c[n]) * (pw[0][i] * pw[1][j]
                                              * pw[2][k] * g[n])
            out[lo:lo + step, a, b, cc] = (Kr * ar.rnd(acc)).sum(-1)
    return out


# ----------------------------------------------------------------------
# Truncated Taylor series in (x, y, z), powers <= 2 of each variable
# ----------------------------------------------------------------------

@functools.cache
def _product_pairs():
    src1, src2, dst = [], [], []
    for (i1, j1, k1), (i2, j2, k2) in itertools.product(
            itertools.product(range(3), repeat=3), repeat=2):
        i, j, k = i1 + i2, j1 + j2, k1 + k2
        if i <= 2 and j <= 2 and k <= 2:
            src1.append(9 * i1 + 3 * j1 + k1)
            src2.append(9 * i2 + 3 * j2 + k2)
            dst.append(9 * i + 3 * j + k)
    return src1, src2, dst


def _mul(A, B):
    """Truncated product of series [P, 27] (flat (i, j, k) order)."""
    s1, s2, dst = (torch.tensor(v, device=A.device)
                   for v in _product_pairs())
    out = torch.zeros_like(A)
    out.index_add_(1, dst, A[:, s1] * B[:, s2])
    return out


@functools.cache
def _tanh_derivative_polys():
    """Coefficients (in t = tanh u, lowest power first) of the k-th
    derivative of tanh u, k = 0..6."""
    polys = [np.array([0.0, 1.0])]
    sech2 = np.array([1.0, 0.0, -1.0])
    for _ in range(6):
        polys.append(np.polynomial.polynomial.polymul(
            np.polynomial.polynomial.polyder(polys[-1]), sech2))
    return polys


def _factorials():
    return torch.tensor([math.factorial(i) * math.factorial(j)
                         * math.factorial(k)
                         for i, j, k in itertools.product(range(3),
                                                          repeat=3)],
                        dtype=torch.float64)


def capped_derivatives(U, cap, spacing):
    """The cap V = cap tanh(U / cap) of 27-derivative fields U [P, 3, 3, 3]
    (physical units), in cell-fractional units: the series of w = U / cap
    in the cell fractions composed with tanh's; where U < 0.1 cap, V = U;
    where U > 20 cap, V is the cap and its derivatives 0."""
    P = U.shape[0]
    fact = _factorials().to(U.device, U.dtype)
    Us = U * cell_fraction_scale(spacing, U.dtype, U.device)
    W = (Us / cap).reshape(P, 27) / fact
    w0 = W[:, 0]
    t = torch.tanh(w0)
    delta = W.clone()
    delta[:, 0] = 0.0
    V = torch.zeros_like(W)
    power = torch.zeros_like(W)
    power[:, 0] = 1.0
    for k, poly in enumerate(_tanh_derivative_polys()):
        tk = sum(float(cf) * t ** e for e, cf in enumerate(poly))
        V = V + (tk / math.factorial(k))[:, None] * power
        if k < 6:
            power = _mul(power, delta)
    V = (cap * V * fact).reshape(U.shape)
    saturated = torch.zeros_like(V)
    saturated[:, 0, 0, 0] = cap
    V = torch.where((w0 > 20.0)[:, None, None, None], saturated, V)
    return torch.where((w0 < 0.1)[:, None, None, None], Us, V)


def cell_fraction_scale(spacing, dtype, device):
    """spacing^order along each axis [3, 3, 3]."""
    h = [torch.tensor([1.0, s, s * s], dtype=dtype, device=device)
         for s in spacing]
    return h[0][:, None, None] * h[1][None, :, None] * h[2][None, None, :]


def grid_data(kind, flat, counts, origin, spacing, grid_types, receptor,
              cap, ar):
    """The stored grid data at the flat point indices [P]: capped values
    [P, G] (``kind`` "values") or cell-fractional 27-derivative arrays
    [P, G, 3, 3, 3] ("derivatives"), for the receptor (coords, charges,
    sigmas, epsilons as numpy) in the arithmetic ``ar``."""
    dev = flat.device
    pts = point_coords(flat, counts, origin, spacing, ar.dtype)
    atoms = torch.as_tensor(receptor[0], dtype=ar.dtype, device=dev)
    out = []
    for gt in grid_types:
        K = torch.as_tensor(strengths(gt, *receptor[1:]), dtype=ar.dtype,
                            device=dev)
        if kind == "values":
            out.append(capped_values(pts, atoms, K, gt, cap, ar))
        else:
            out.append(capped_derivatives(
                raw_derivatives(pts, atoms, K, gt, ar), cap, spacing))
    return torch.stack(out, dim=1)
