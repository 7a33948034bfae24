"""Packed per-cell polynomial grids: one row gather per atom.

Inside any cell, trilinear and cubic B-spline interpolation evaluate a
fixed tensor-product polynomial of the cell fraction,
P(s) = sum c_pqr sx^p sy^q sz^r. The coefficients do not depend on the
atom position, so ``pack_grid`` computes them once per cell (in float64,
then cast), and evaluation is one gather of a contiguous row per atom plus
a few small contractions.

Semantics follow the JAX module exactly: cell index clamped to
[0, counts-2] and fraction to [0, 1]; an unscaled harmonic restraint for
atoms outside the box, applied once per fused set; atoms inside the box
contribute only where their scaling is non-zero; the inverse-power
back-transform sign(v)|v|^n with its 1e-10 dead zone. The fused table is
[ncells, G*K], without the TPU's 128-lane padding. Hermite and Chebyshev
packs and slab-wise packing wait for later slices (ROADMAP).

Positions may carry any leading batch dimensions, [..., N, 3] (replicas
are [R, N, 3]); per-atom scalings are shared across them.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..grid import Grid, InterpolationMethod, InvPowerMode
from . import basis
from .chain_rules import invpower_value


class GridEval(NamedTuple):
    energy: torch.Tensor           # [...]: total grid energy
    forces: torch.Tensor           # [..., N, 3]
    per_atom_energy: torch.Tensor  # [..., N]


# ----------------------------------------------------------------------
# Basis -> monomial coefficient matrices
# ----------------------------------------------------------------------

@lru_cache(maxsize=None)
def _value_axis_matrix(method: int) -> np.ndarray:
    """C[p, a]: monomial coefficients of the per-axis stencil weight for
    offset a, fitted in float64 from the basis functions at degree+1
    nodes (exact for these degrees)."""
    if method == InterpolationMethod.TRILINEAR:
        fn, degree = basis.trilinear_weights, 1
    elif method == InterpolationMethod.BSPLINE:
        fn, degree = basis.bspline_weights, 3
    else:
        raise ValueError(method)
    t = np.linspace(0.0, 1.0, degree + 1)
    V = np.vander(t, degree + 1, increasing=True)    # [nodes, powers]
    vals = fn(torch.from_numpy(t)).numpy()           # [nodes, nbasis]
    return np.linalg.solve(V, vals)                   # [powers, nbasis]


def _poly_powers(v, d: int):
    """[..., d] monomials v^p."""
    return torch.stack([v ** p for p in range(d)], dim=-1)


def _poly_dpowers(v, d: int):
    """[..., d] d/dv of the monomials."""
    return torch.stack([torch.zeros_like(v)]
                       + [p * v ** (p - 1) for p in range(1, d)], dim=-1)


# ----------------------------------------------------------------------
# Packing
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedGrid:
    """Per-cell monomial coefficients plus evaluation config."""

    coeffs: torch.Tensor          # [ncells, K], K = degree^3
    spacing: torch.Tensor         # [3]
    origin: torch.Tensor          # [3]
    counts: tuple = (0, 0, 0)
    degree: int = 2
    # inverse-power back-transform exponent (0 = disabled); RUNTIME stencil
    # transforms are folded into the coefficients at pack time
    back_power: float = 0.0
    oob_k: float = 0.0


def _edge_pad(P, lo: int, hi: int):
    """Pad every axis by ``lo`` and ``hi`` copies of its edge planes."""
    for axis in range(3):
        n = P.shape[axis]
        idx = torch.arange(-lo, n + hi, device=P.device).clamp(0, n - 1)
        P = P.index_select(axis, idx)
    return P


def _pack_values(vals, method, runtime_inv, inv_power, counts):
    nx, ny, nz = counts
    ncx, ncy, ncz = nx - 1, ny - 1, nz - 1
    C = torch.as_tensor(_value_axis_matrix(method), dtype=vals.dtype,
                        device=vals.device)
    P = vals
    if runtime_inv:
        # fold the stencil transform into packing
        P = invpower_value(P, 1.0 / inv_power)
    if method == InterpolationMethod.BSPLINE:
        # stencil offsets -1..+2 with index clamping == edge padding
        P = _edge_pad(P, 1, 2)

    def contract(x, axis, ncells_axis):
        S = torch.stack([x.narrow(axis, a, ncells_axis)
                         for a in range(C.shape[1])], dim=0)
        return torch.einsum("pa,a...->p...", C, S)

    T = contract(P, 0, ncx)          # [px, i, y, z]
    T = contract(T, 2, ncy)          # [py, px, i, j, z]
    T = contract(T, 4, ncz)          # [pz, py, px, i, j, k]
    coeffs = T.permute(3, 4, 5, 2, 1, 0)   # [i, j, k, px, py, pz]
    return coeffs.reshape(ncx * ncy * ncz, C.shape[0] ** 3)


def pack_grid(grid: Grid, dtype=None) -> PackedGrid:
    """Per-cell monomial coefficients of a trilinear or B-spline Grid.

    Packs in float64 on the grid's device and casts the table to
    ``dtype`` (default: the grid's dtype).
    """
    dtype = dtype or grid.vals.dtype
    method = grid.interp_method
    if method not in (InterpolationMethod.TRILINEAR,
                      InterpolationMethod.BSPLINE):
        raise NotImplementedError(
            f"packing {InterpolationMethod(method).name} grids is not "
            "ported yet (ROADMAP: Hermite packs, Queue A item 9)")
    back_power = 0.0
    if grid.inv_power_mode in (InvPowerMode.RUNTIME, InvPowerMode.STORED) \
            and grid.inv_power != 0.0:
        back_power = grid.inv_power
    runtime_inv = (grid.inv_power_mode == InvPowerMode.RUNTIME
                   and grid.inv_power != 0.0)
    coeffs = _pack_values(grid.vals.to(torch.float64), int(method),
                          runtime_inv, grid.inv_power, grid.counts)
    return PackedGrid(
        coeffs=coeffs.to(dtype).contiguous(),
        spacing=grid.spacing.to(dtype),
        origin=grid.origin.to(dtype),
        counts=grid.counts,
        degree=2 if method == InterpolationMethod.TRILINEAR else 4,
        back_power=back_power,
        oob_k=grid.oob_k,
    )


# ----------------------------------------------------------------------
# Evaluation
# ----------------------------------------------------------------------

def _locate(positions, spacing, origin, counts):
    """Box test, clamped cell index and fraction of positions [..., 3].

    Returns (pos, corner, inside [...], cell [...], f [..., 3])."""
    dtype = spacing.dtype
    pos = positions - origin
    fcounts = torch.tensor(counts, dtype=dtype, device=pos.device)
    corner = spacing * (fcounts - 1.0)
    inside = ((pos >= 0.0) & (pos <= corner)).all(-1)
    t = pos / spacing
    hi = torch.tensor(counts, device=pos.device) - 2
    ixyz = torch.minimum(torch.floor(t).to(torch.int64).clamp_min(0), hi)
    f = (t - ixyz).clamp(0.0, 1.0)
    ncy, ncz = counts[1] - 1, counts[2] - 1
    cell = (ixyz[..., 0] * ncy + ixyz[..., 1]) * ncz + ixyz[..., 2]
    return pos, corner, inside, cell, f


def _oob_deviation(pos, corner):
    zero = torch.zeros_like(pos)
    return torch.where(pos < 0.0, pos,
                       torch.where(pos > corner, pos - corner, zero))


def _tensor_poly(R, f, d):
    """Value and fraction-gradient of the cell polynomials R [..., d,d,d]
    (leading dims broadcast against f [..., 3]). Returns (P, grad [.., 3])."""
    px, py, pz = (_poly_powers(f[..., a], d) for a in range(3))
    dpx, dpy, dpz = (_poly_dpowers(f[..., a], d) for a in range(3))
    extra = R.dim() - 3 - (f.dim() - 1)   # grid axis between atoms and pqr

    def lift(v):
        return v.reshape(v.shape[:-1] + (1,) * extra + v.shape[-1:])

    px, py, pz, dpx, dpy, dpz = map(lift, (px, py, pz, dpx, dpy, dpz))
    Rz = (R * pz[..., None, None, :]).sum(-1)       # [..., d, d]
    Rdz = (R * dpz[..., None, None, :]).sum(-1)
    Ry = (Rz * py[..., None, :]).sum(-1)            # [..., d]
    Rdy = (Rz * dpy[..., None, :]).sum(-1)
    Rzdy = (Rdz * py[..., None, :]).sum(-1)
    P = (Ry * px).sum(-1)
    grad = torch.stack([(Ry * dpx).sum(-1), (Rdy * px).sum(-1),
                        (Rzdy * px).sum(-1)], dim=-1)
    return P, grad


def evaluate_packed(packed: PackedGrid, positions,
                    scaling_factors) -> GridEval:
    """Energy and forces of atoms [..., N, 3] on one packed grid."""
    dtype = packed.coeffs.dtype
    positions = positions.to(dtype)
    scaling = torch.as_tensor(scaling_factors, dtype=dtype,
                              device=positions.device)
    pos, corner, inside, cell, f = _locate(positions, packed.spacing,
                                           packed.origin, packed.counts)
    d = packed.degree
    rows = packed.coeffs.index_select(0, cell.reshape(-1))
    R = rows.reshape(cell.shape + (d, d, d))
    interp, grad_s = _tensor_poly(R, f, d)

    if packed.back_power != 0.0:
        n = packed.back_power
        sign = torch.where(interp >= 0.0, 1.0, -1.0).to(dtype)
        a = interp.abs()
        active = a > 1e-10
        a_safe = torch.where(active, a, torch.ones_like(a))
        pf = n * a_safe ** (n - 1.0)
        interp = torch.where(active, sign * a_safe ** n, interp)
        grad_s = torch.where(active[..., None], grad_s * pf[..., None],
                             grad_s)

    grad_phys = grad_s / packed.spacing
    energy_in = scaling * interp
    force_in = -scaling[..., None] * grad_phys

    dev = _oob_deviation(pos, corner)
    energy_oob = 0.5 * packed.oob_k * (dev * dev).sum(-1)
    force_oob = -packed.oob_k * dev

    active = inside & (scaling != 0.0)
    per_atom = torch.where(active, energy_in, energy_oob)
    forces = torch.where(active[..., None], force_in, force_oob)
    return GridEval(per_atom.sum(-1), forces, per_atom)


# ----------------------------------------------------------------------
# Multi-grid fusion: co-located grids share one gather
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultiPackedGrid:
    """G packed grids with identical geometry fused into one coefficient
    table [ncells, G*K]: one row gather per atom serves all G grids."""

    coeffs: torch.Tensor          # [ncells, G*K]
    spacing: torch.Tensor
    origin: torch.Tensor
    counts: tuple = (0, 0, 0)
    degree: int = 2
    n_grids: int = 1
    back_powers: tuple = ()
    oob_k: float = 0.0


def combine_packed_grids(packed_grids) -> MultiPackedGrid:
    """Fuse PackedGrids with identical geometry and degree into one
    table [ncells, G*K]."""
    first = packed_grids[0]
    for p in packed_grids[1:]:
        if (p.counts != first.counts or p.degree != first.degree
                or p.oob_k != first.oob_k):
            raise ValueError("grids must share counts/degree/oob_k to fuse")
        if not (torch.allclose(p.spacing, first.spacing)
                and torch.allclose(p.origin, first.origin)):
            raise ValueError("grids must be co-located (same spacing and "
                             "origin) to fuse — evaluation would use the "
                             "first grid's geometry for all")
    return MultiPackedGrid(
        coeffs=torch.cat([p.coeffs for p in packed_grids], dim=1),
        spacing=first.spacing,
        origin=first.origin,
        counts=first.counts,
        degree=first.degree,
        n_grids=len(packed_grids),
        back_powers=tuple(p.back_power for p in packed_grids),
        oob_k=first.oob_k,
    )


def evaluate_multi(multi: MultiPackedGrid, positions, scaling_factors):
    """Evaluate all fused grids with one gather per atom.

    Args:
      positions: [..., N, 3].
      scaling_factors: [G, N] per-grid per-atom scalings.

    Returns GridEval where per-atom energies/forces are summed over grids;
    the out-of-bounds restraint is applied once for the fused set.
    """
    dtype = multi.coeffs.dtype
    positions = positions.to(dtype)
    scaling = torch.as_tensor(scaling_factors, dtype=dtype,
                              device=positions.device)       # [G, N]
    pos, corner, inside, cell, f = _locate(positions, multi.spacing,
                                           multi.origin, multi.counts)
    d = multi.degree
    G = multi.n_grids
    rows = multi.coeffs.index_select(0, cell.reshape(-1))
    R = rows.reshape(cell.shape + (G, d, d, d))
    interp, grad_s = _tensor_poly(R, f, d)             # [..., N, G(, 3)]

    if any(bp != 0.0 for bp in multi.back_powers):
        bps = torch.tensor(multi.back_powers, dtype=dtype,
                           device=positions.device)
        enabled = bps != 0.0
        sign = torch.where(interp >= 0.0, 1.0, -1.0).to(dtype)
        a = interp.abs()
        act = (a > 1e-10) & enabled
        one = torch.ones_like(a)
        a_safe = torch.where(act, a, one)
        pf = torch.where(act, bps * a_safe ** (bps - 1.0), one)
        interp = torch.where(act, sign * a_safe ** bps, interp)
        grad_s = grad_s * pf[..., None]

    grad_phys = grad_s / multi.spacing                 # [..., N, G, 3]
    s_t = scaling.transpose(0, 1)                       # [N, G]
    active = inside[..., None] & (s_t != 0.0)           # [..., N, G]
    zero = torch.zeros((), dtype=dtype, device=positions.device)
    per_atom = torch.where(active, s_t * interp, zero).sum(-1)
    force_in = -torch.where(active[..., None], s_t[..., None] * grad_phys,
                            zero).sum(-2)

    dev = _oob_deviation(pos, corner)
    oob = ~inside
    per_atom = per_atom + torch.where(
        oob, 0.5 * multi.oob_k * (dev * dev).sum(-1), zero)
    forces = force_in + torch.where(oob[..., None], -multi.oob_k * dev, zero)
    return GridEval(per_atom.sum(-1), forces, per_atom)
