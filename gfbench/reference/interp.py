"""Interpolation on the configuration's grids, and a reader of packed
tables.

Semantics: a position inside the box [origin, origin + (n - 1) spacing] on
every axis lies in the cell floor((x - origin) / spacing), clamped to the
last cell, at the fraction (x - origin) / spacing - cell, clamped to
[0, 1]. The approximating cubic B-spline reads the values at the cell's
offsets -1..+2 (clamped to the grid); the triquintic Hermite cell reads the
27 cell-fractional derivatives at its 8 corners. A packed table's row (one
a cell, (i * ncy + j) * ncz + k) holds, grid after grid, the coefficients
c[p, q, r] of the cell's polynomial in the fractions, in monomials f^p or
Chebyshev polynomials T_p(2f - 1).

Gradients here are with respect to the cell fractions.
"""

from __future__ import annotations

import torch

# quintic Hermite basis on [0, 1], by (derivative order, side), as power
# coefficients t^0..t^5: order m on side s has m-th derivative 1 at s and
# every other derivative up to the second 0 at both ends
_HERMITE5 = (((1.0, 0.0, 0.0, -10.0, 15.0, -6.0),
              (0.0, 0.0, 0.0, 10.0, -15.0, 6.0)),
             ((0.0, 1.0, 0.0, -6.0, 8.0, -3.0),
              (0.0, 0.0, 0.0, -4.0, 7.0, -3.0)),
             ((0.0, 0.0, 0.5, -1.5, 1.5, -0.5),
              (0.0, 0.0, 0.0, 0.5, -1.0, 0.5)))


def locate(pos, origin, spacing, counts):
    """(inside [...], cell [..., 3] int64, fraction [..., 3]) of positions
    [..., 3]."""
    o = torch.as_tensor(origin, dtype=pos.dtype, device=pos.device)
    h = torch.as_tensor(spacing, dtype=pos.dtype, device=pos.device)
    n = torch.as_tensor(counts, device=pos.device)
    rel = pos - o
    inside = ((rel >= 0) & (rel <= h * (n - 1).to(pos.dtype))).all(-1)
    t = rel / h
    cell = torch.minimum(torch.floor(t).long().clamp_min(0), n - 2)
    frac = (t - cell.to(pos.dtype)).clamp(0.0, 1.0)
    return inside, cell, frac


def _flat(i, j, k, counts):
    return (i * counts[1] + j) * counts[2] + k


def bspline_points(cell, counts):
    """Flat indices [..., 4, 4, 4] of a cell's B-spline stencil."""
    off = torch.arange(-1, 3, device=cell.device)
    ax = [(cell[..., a, None] + off).clamp(0, counts[a] - 1)
          for a in range(3)]
    return _flat(ax[0][..., :, None, None], ax[1][..., None, :, None],
                 ax[2][..., None, None, :], counts)


def bspline_weights(f):
    """The four cubic B-spline weights [..., 4] at fraction f."""
    g = 1.0 - f
    return torch.stack([g ** 3 / 6.0,
                        (3.0 * f ** 3 - 6.0 * f ** 2 + 4.0) / 6.0,
                        (-3.0 * f ** 3 + 3.0 * f ** 2 + 3.0 * f + 1.0) / 6.0,
                        f ** 3 / 6.0], dim=-1)


def bspline_value(vals, frac, ar):
    """Interpolated values [..., G] from stencil values [..., G, 4, 4, 4]
    (differentiable in ``frac``)."""
    w = [ar.rnd(bspline_weights(frac[..., a])) for a in range(3)]
    return torch.einsum("...i,...j,...k,...gijk->...g", w[0], w[1], w[2],
                        ar.rnd(vals))


def corner_points(cell, counts):
    """Flat indices [..., 2, 2, 2] of a cell's corners."""
    off = torch.arange(2, device=cell.device)
    ax = [cell[..., a, None] + off for a in range(3)]
    return _flat(ax[0][..., :, None, None], ax[1][..., None, :, None],
                 ax[2][..., None, None, :], counts)


def hermite5_weights(f):
    """[..., 3 orders, 2 sides] quintic Hermite basis at fraction f."""
    c = torch.tensor(_HERMITE5, dtype=f.dtype, device=f.device)
    powers = torch.stack([f ** e for e in range(6)], dim=-1)
    return torch.einsum("...e,mse->...ms", powers, c)


def hermite_value(D, frac, ar):
    """Interpolated values [..., G] from corner data
    [..., G, 2, 2, 2, 3, 3, 3] (corner x, y, z; orders x, y, z)."""
    H = [ar.rnd(hermite5_weights(frac[..., a])) for a in range(3)]
    return torch.einsum("...ax,...by,...cz,...gxyzabc->...g", H[0], H[1],
                        H[2], ar.rnd(D))


def value_and_gradient(fn, frac):
    """fn(frac) [..., G] and its gradient in the fractions [..., G, 3]."""
    f = frac.detach().requires_grad_(True)
    with torch.enable_grad():
        v = fn(f)
        grads = [torch.autograd.grad(v[..., g].sum(), f, retain_graph=True)[0]
                 for g in range(v.shape[-1])]
    return v.detach(), torch.stack(grads, dim=-2)


def _basis(f, d, poly_basis):
    """[..., d] basis values at fraction f: f^p or T_p(2f - 1)."""
    if poly_basis == "monomial":
        return torch.stack([f ** p for p in range(d)], dim=-1)
    if poly_basis != "chebyshev":
        raise ValueError(f"unknown basis {poly_basis!r}")
    u = 2.0 * f - 1.0
    T = [torch.ones_like(u), u]
    while len(T) < d:
        T.append(2.0 * u * T[-1] - T[-2])
    return torch.stack(T[:d], dim=-1)


def table_value(coeffs, degree, n_grids, poly_basis, counts, cell, frac):
    """A packed table's polynomials [..., G] at cells [..., 3] and
    fractions [..., 3], in float64 (differentiable in ``frac``)."""
    ncy, ncz = counts[1] - 1, counts[2] - 1
    row = (cell[..., 0] * ncy + cell[..., 1]) * ncz + cell[..., 2]
    d = degree
    c = coeffs[row.reshape(-1)].to(torch.float64)
    c = c.reshape(row.shape + (n_grids, d, d, d))
    f = frac.to(torch.float64)
    b = [_basis(f[..., a], d, poly_basis) for a in range(3)]
    return torch.einsum("...p,...q,...r,...gpqr->...g", b[0], b[1], b[2], c)
