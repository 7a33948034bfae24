"""Packed per-cell grids: one row gather per atom.

Inside any cell, every interpolation method evaluates a fixed
tensor-product polynomial of the cell fraction,
P(s) = sum c_pqr b_p(sx) b_q(sy) b_r(sz). The coefficients do not depend on
the atom position, so ``pack_grid`` computes them once per cell, and
evaluation is one gather of a contiguous row per atom plus a few small
contractions.

Two polynomial bases: monomials v^p, and Chebyshev T_p(2v - 1). Triquintic
monomial coefficients of steep capped fields reach 1e8-1e10 while cell
values stay near 1e4, so float32 evaluation of the monomial form loses
about 1 kJ/mol near receptor cores; Chebyshev coefficients are bounded by
about max|P| on the cell, at the same evaluation cost. The Hermite-packed
form (``pack_grid_hermite``) keeps the single row gather too, but stores
the 8 corners' derivative vectors per cell and evaluates in the bounded
Hermite basis.

Semantics follow ``ops/interpolate.py`` exactly (same clamping, restraint
and back-transform; RUNTIME stencil transforms are folded into packing).
For a fused set the out-of-bounds restraint is applied once. The fused
tables are [ncells, G*K], without the TPU's 128-lane padding. Large grids
pack in x-slabs (``pack_grid(x_chunk=)``, ``pack_grids_fused``), so the
peak is the table plus one slab.

Positions may carry any leading batch dimensions, [..., N, 3] (replicas
are [R, N, 3]); per-atom scalings are shared across them.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from ..grid import Grid, InterpolationMethod
from ..utils.observe import trace
from . import basis
from .chain_rules import apply_invpower, invpower_value
from .cuda_packed_eval import packed_eval
from .derivatives27 import DERIV_ORDERS, TRICUBIC_DERIV_MAP
from .lanewise import lanewise
from .interpolate import (_CORNER_CX, _CORNER_CY, _CORNER_CZ,
                          HERMITE_FAMILIES, GridEval, _hermite_tensor_eval,
                          cell_index, const_tensor, finish_single,
                          grid_back_power, grid_runtime_inv, locate,
                          oob_deviation)

_HERMITE_METHODS = (InterpolationMethod.TRICUBIC,
                    InterpolationMethod.TRIQUINTIC)
# interpolation method -> per-axis polynomial degree + 1 of its cells
_DEGREES = {int(InterpolationMethod.TRILINEAR): 2,
            int(InterpolationMethod.BSPLINE): 4,
            int(InterpolationMethod.TRICUBIC): 4,
            int(InterpolationMethod.TRIQUINTIC): 6}


# ----------------------------------------------------------------------
# Basis -> polynomial coefficient matrices, fitted in float64 on the host
# ----------------------------------------------------------------------

def _poly_coeffs_from_fn(fn, shape, degree):
    """Exact monomial coefficients [degree+1, *shape] of the polynomial
    basis functions ``fn`` (returning [..., *shape]), from a Vandermonde
    solve at degree+1 nodes."""
    t = np.linspace(0.0, 1.0, degree + 1)
    V = np.vander(t, degree + 1, increasing=True)    # [nodes, powers]
    vals = fn(torch.from_numpy(t)).numpy().reshape(degree + 1, -1)
    return np.linalg.solve(V, vals).reshape((degree + 1,) + shape)


@lru_cache(maxsize=None)
def _value_axis_matrix(method: int) -> np.ndarray:
    """C[p, a]: monomial coefficients of the per-axis stencil weight for
    offset a (value-based methods)."""
    if method == InterpolationMethod.TRILINEAR:
        return _poly_coeffs_from_fn(basis.trilinear_weights, (2,), 1)
    if method == InterpolationMethod.BSPLINE:
        return _poly_coeffs_from_fn(basis.bspline_weights, (4,), 3)
    raise ValueError(method)


@lru_cache(maxsize=None)
def _hermite_axis_matrix(method: int) -> np.ndarray:
    """H[p, m, s]: monomial coefficients of the Hermite basis H_{m,s}."""
    if method == InterpolationMethod.TRICUBIC:
        return _poly_coeffs_from_fn(basis.hermite3_weights, (2, 2), 3)
    if method == InterpolationMethod.TRIQUINTIC:
        return _poly_coeffs_from_fn(basis.hermite5_weights, (3, 2), 5)
    raise ValueError(method)


@lru_cache(maxsize=None)
def _monomial_to_cheb(d: int) -> np.ndarray:
    """B[p, j]: turns monomial coefficients a_j (in v on [0, 1]) into the
    Chebyshev coefficients b_p of the same polynomial in T_p(2v - 1)."""
    # C2M[p, j] = coefficient of v^j in T_p(2v - 1)
    C2M = np.zeros((d, d))
    pv = np.polynomial.polynomial.Polynomial([-1.0, 2.0])   # u = 2v - 1
    for pp in range(d):
        c = np.zeros(pp + 1)
        c[pp] = 1.0
        out = np.polynomial.polynomial.Polynomial([0.0])
        for j, cj in enumerate(np.polynomial.chebyshev.cheb2poly(c)):
            out = out + cj * pv ** j
        C2M[pp, :len(out.coef)] = out.coef
    return np.linalg.inv(C2M).T


@lru_cache(maxsize=None)
def _hermite_axis_matrix_cheb(method: int) -> np.ndarray:
    """Hc[p, m, s]: Chebyshev coefficients (in T_p(2v - 1)) of the Hermite
    basis H_{m,s}: the monomial axis matrix composed with the change of
    basis, in float64. Packing with Hc yields Chebyshev cell coefficients
    directly: the huge, cancellation-prone monomial coefficients are never
    formed, each axis contraction gives bounded coefficients of a partial
    interpolant, and the pack can run in the grid's own dtype."""
    H = _hermite_axis_matrix(method)
    return np.einsum("pj,jms->pms", _monomial_to_cheb(H.shape[0]), H)


def _poly_powers(v, d: int, poly_basis: str):
    """[..., d] basis values at cell fraction v: v^p or T_p(2v - 1)."""
    if poly_basis == "monomial":
        # by products, as the kernel forms them (no pow: ATen's rounds an
        # element by where it lies, ops/lanewise.py)
        P = [torch.ones_like(v)]
        for _ in range(1, d):
            P.append(P[-1] * v)
        return torch.stack(P, dim=-1)
    u = 2.0 * v - 1.0
    T = [torch.ones_like(v), u]
    for _ in range(2, d):
        T.append(2.0 * u * T[-1] - T[-2])
    return torch.stack(T[:d], dim=-1)


def _poly_dpowers(v, d: int, poly_basis: str):
    """[..., d] d/dv of the basis values."""
    if poly_basis == "monomial":
        P = _poly_powers(v, d - 1, poly_basis)
        return torch.stack([torch.zeros_like(v)]
                           + [p * P[..., p - 1] for p in range(1, d)],
                           dim=-1)
    # d/dv T_p(2v - 1) = 2 p U_{p-1}(2v - 1)
    u = 2.0 * v - 1.0
    U = [torch.ones_like(v), 2.0 * u]
    for _ in range(2, d - 1):
        U.append(2.0 * u * U[-1] - U[-2])
    return torch.stack([torch.zeros_like(v)]
                       + [2.0 * p * U[p - 1] for p in range(1, d)], dim=-1)


def _host_contract(C, S, n_axes=1, perm=None):
    """The host's form of an axis contraction ``torch.einsum`` does on the
    card: out[p, ...] = sum_a C[p, a] S[a, ...] over the ``n_axes``
    trailing axes of C [P, ...], which ``perm`` brings to the front of S
    in C's order, the terms added one by one in a fixed order. BLAS
    splits a product of this shape by the thread count, and MKL on a CPU
    without AVX-512 then sums a coefficient's few terms in another order
    with 2 threads than with 1: a pack would depend on the threads of the
    process that made it (a rank of a mesh runs with its share of the
    cores)."""
    if perm is not None:
        S = S.permute(perm)
    k = int(np.prod(C.shape[1:]))
    C = C.reshape(C.shape[0], k)
    S = S.reshape((k,) + tuple(S.shape[n_axes:]))
    lift = (slice(None),) + (None,) * (S.dim() - 1)
    out = C[:, 0][lift] * S[0]
    for a in range(1, k):
        out = out + C[:, a][lift] * S[a]
    return out


def _coeffs_to_cheb(coeffs, d: int):
    """[ncells, d^3] monomial -> Chebyshev tensor coefficients."""
    B = torch.as_tensor(_monomial_to_cheb(d), dtype=coeffs.dtype,
                        device=coeffs.device)
    X = coeffs.reshape(-1, d, d, d)
    if coeffs.is_cuda:
        R = torch.einsum("pi,qj,rk,cijk->cpqr", B, B, B, X)
    else:
        T = _host_contract(B, X, perm=(3, 0, 1, 2))      # [r, c, i, j]
        T = _host_contract(B, T, perm=(3, 0, 1, 2))      # [q, r, c, i]
        T = _host_contract(B, T, perm=(3, 0, 1, 2))      # [p, q, r, c]
        R = T.permute(3, 0, 1, 2)
    return R.reshape(-1, d ** 3)


# the canonical 27-slot order as a [mx, my, mz] lookup
_D27_TO_M3 = np.zeros((3, 3, 3), dtype=np.int64)
for _i, (_a, _b, _c) in enumerate(DERIV_ORDERS):
    _D27_TO_M3[_a, _b, _c] = _i


# ----------------------------------------------------------------------
# Packing
# ----------------------------------------------------------------------

class _Cells:
    """Members every pack shares with the JAX package's."""

    @property
    def cell_counts(self):
        nx, ny, nz = self.counts
        return (nx - 1, ny - 1, nz - 1)


class _FusedCells(_Cells):
    @property
    def num_grids(self) -> int:
        return self.n_grids


@dataclasses.dataclass(frozen=True)
class PackedGrid(_Cells):
    """Per-cell polynomial coefficients plus evaluation config."""

    coeffs: torch.Tensor          # [ncells, K], K = degree^3
    spacing: torch.Tensor         # [3]
    origin: torch.Tensor          # [3]
    counts: tuple = (0, 0, 0)
    degree: int = 2
    # inverse-power back-transform exponent (0 = disabled); RUNTIME stencil
    # transforms are folded into the coefficients at pack time
    back_power: float = 0.0
    oob_k: float = 0.0
    poly_basis: str = "monomial"


def _edge_pad(P, lo: int, hi: int, axes=(0, 1, 2)):
    """Pad each of ``axes`` by ``lo`` and ``hi`` copies of its edge planes."""
    for axis in axes:
        n = P.shape[axis]
        idx = torch.arange(-lo, n + hi, device=P.device).clamp(0, n - 1)
        P = P.index_select(axis, idx)
    return P


def points_read(method, c0: int, c1: int, nx: int) -> tuple:
    """The x-points [lo, hi) that the cells [c0, c1) of a pack read: a
    B-spline cell's stencil spans offsets -1..+2 (clamped at the grid's
    ends); every other method's cells read their corners [c0, c1]."""
    if method == InterpolationMethod.BSPLINE:
        return max(c0 - 1, 0), min(c1 + 3, nx)
    return c0, c1 + 1


def _value_planes(vals, method, c0: int, c1: int, first: int = 0,
                  nx: int | None = None):
    """The value planes that cells [c0, c1) along x read, padded for
    ``_pack_values_padded``: a B-spline slab brings its stencil's real
    neighbour planes (offsets -1..+2, clamped at the grid's ends, which is
    edge padding) and is edge-padded along y and z; a trilinear slab is
    the points [c0, c1]. ``vals`` holds the grid's x-points from ``first``
    on, of ``nx`` in all (default: the whole grid)."""
    nx = vals.shape[0] + first if nx is None else nx
    if method == InterpolationMethod.BSPLINE:
        idx = torch.arange(c0 - 1, c1 + 3, device=vals.device).clamp(
            0, nx - 1) - first
        return _edge_pad(vals.index_select(0, idx), 1, 2, axes=(1, 2))
    return vals[c0 - first:c1 + 1 - first]


def _pack_values_padded(P, method, runtime_inv, inv_power, ncells):
    """Per-cell coefficients [ncx * ncy * ncz, K] of the cells ``ncells``
    from value planes that carry their stencil (``_value_planes``)."""
    ncx, ncy, ncz = ncells
    with trace("omgf.sync.value_basis"):
        C = torch.as_tensor(_value_axis_matrix(method), dtype=P.dtype,
                            device=P.device)
    if runtime_inv:
        # fold the stencil transform into packing
        P = invpower_value(P, 1.0 / inv_power)

    def contract(x, axis, ncells_axis):
        S = torch.stack([x.narrow(axis, a, ncells_axis)
                         for a in range(C.shape[1])], dim=0)
        if S.is_cuda:
            return torch.einsum("pa,a...->p...", C, S)
        return _host_contract(C, S)

    T = contract(P, 0, ncx)          # [px, i, y, z]
    T = contract(T, 2, ncy)          # [py, px, i, j, z]
    T = contract(T, 4, ncz)          # [pz, py, px, i, j, k]
    coeffs = T.permute(3, 4, 5, 2, 1, 0)   # [i, j, k, px, py, pz]
    return coeffs.reshape(ncx * ncy * ncz, C.shape[0] ** 3)


def _pack_derivs(derivs, method, runtime_inv, inv_power, counts, out_basis):
    """Per-cell coefficients [ncells, K] of a Hermite-method grid from its
    derivatives [nx, ny, nz, 27]: one separable contraction per axis with
    the Hermite axis matrix in the chosen basis."""
    nx, ny, nz = counts
    ncx, ncy, ncz = nx - 1, ny - 1, nz - 1
    with trace("omgf.sync.hermite_basis"):
        H = torch.as_tensor(_hermite_axis_matrix(method)
                            if out_basis == "monomial"
                            else _hermite_axis_matrix_cheb(method),
                            dtype=derivs.dtype, device=derivs.device)
        m = H.shape[1]  # 2 (tricubic) or 3 (triquintic)
        # reindex [.., 27] -> [.., mx, my, mz], restricted to orders < m
        sel = torch.as_tensor(_D27_TO_M3[:m, :m, :m].reshape(-1),
                              device=derivs.device)
    if runtime_inv:
        derivs = apply_invpower(derivs, 1.0 / inv_power)
    D = derivs.index_select(-1, sel).reshape(nx, ny, nz, m, m, m)

    def contract(spec, S, axis):
        # the axis' derivative order and the corner s, in H's order
        if S.is_cuda:
            return torch.einsum(spec, H, S)
        perm = (axis, 0) + tuple(a for a in range(1, S.dim()) if a != axis)
        return _host_contract(H, S, 2, perm)

    Sx = torch.stack([D[0:ncx], D[1:ncx + 1]], dim=0)
    T = contract("pms,sijkmno->pijkno", Sx, 4)
    Sy = torch.stack([T[:, :, 0:ncy], T[:, :, 1:ncy + 1]], dim=0)
    T = contract("qns,spijkno->qpijko", Sy, 5)
    Sz = torch.stack([T[:, :, :, :, 0:ncz], T[:, :, :, :, 1:ncz + 1]],
                     dim=0)
    T = contract("ros,sqpijko->rqpijk", Sz, 6)
    coeffs = T.permute(3, 4, 5, 2, 1, 0)   # [i, j, k, px, py, pz]
    return coeffs.reshape(ncx * ncy * ncz, H.shape[0] ** 3)


def _write_rows(out, part, row: int, col: int):
    """Write the block ``part`` into ``out`` at (row, col), in place."""
    out[row:row + part.shape[0], col:col + part.shape[1]] = part


def _pack_cells(grid: Grid, c0: int, c1: int, dtype, poly_basis, device,
                first: int = 0):
    """Coefficient rows [(c1 - c0) * ncy * ncz, K] in ``dtype`` of the
    grid's cells [c0, c1) along x, computed on ``device`` from the planes
    they read. Value methods contract in float64 and cast; Hermite
    methods contract in ``dtype`` (see ``pack_grid``). ``grid``'s
    ``vals`` and ``derivs`` may hold only the x-points from ``first`` on
    (an x-slab with its halo)."""
    method = int(grid.interp_method)
    nx, ny, nz = grid.counts
    runtime_inv = grid_runtime_inv(grid)
    if method in _HERMITE_METHODS:
        if grid.derivs is None:
            raise ValueError("Hermite methods need precomputed derivatives")
        return _pack_derivs(grid.derivs[c0 - first:c1 + 1 - first].to(
                                device, dtype), method,
                            runtime_inv, grid.inv_power,
                            (c1 - c0 + 1, ny, nz), poly_basis)
    P = _value_planes(grid.vals, method, c0, c1, first, nx).to(
        device, torch.float64)
    coeffs = _pack_values_padded(P, method, runtime_inv, grid.inv_power,
                                 (c1 - c0, ny - 1, nz - 1))
    if poly_basis == "chebyshev":
        coeffs = _coeffs_to_cheb(coeffs, _DEGREES[method])
    return coeffs.to(dtype)


def _default_basis(method: int, dtype) -> str:
    """Chebyshev for float32 packs of the Hermite methods, where the
    monomial form loses about 1 kJ/mol near receptor cores; monomial
    otherwise."""
    return ("chebyshev" if method in _HERMITE_METHODS
            and dtype == torch.float32 else "monomial")


# above this many cells a pack is built in x-slabs by default
SLAB_CELLS = 2_000_000
SLAB_X_CHUNK = 64


def _pack_table(grids, dtype, poly_basis, x_chunk, device):
    """The coefficient table [ncells, G*K] of co-located grids of one
    method on ``device``: grid g's coefficients in columns [g*K, (g+1)*K).
    Packed whole, or in x-slabs of ``x_chunk`` cells written into the
    preallocated table one by one, so the transient peak is the table plus
    one slab (default: whole up to SLAB_CELLS cells, SLAB_X_CHUNK-cell
    slabs above)."""
    ncx, ncy, ncz = (c - 1 for c in grids[0].counts)
    if x_chunk is None:
        x_chunk = ncx if ncx * ncy * ncz <= SLAB_CELLS else SLAB_X_CHUNK
    if len(grids) == 1 and x_chunk >= ncx:
        return _pack_cells(grids[0], 0, ncx, dtype, poly_basis, device)
    K = _DEGREES[int(grids[0].interp_method)] ** 3
    out = torch.empty((ncx * ncy * ncz, len(grids) * K), dtype=dtype,
                      device=device)
    for gi, g in enumerate(grids):
        for c0 in range(0, ncx, x_chunk):
            c1 = min(c0 + x_chunk, ncx)
            _write_rows(out, _pack_cells(g, c0, c1, dtype, poly_basis,
                                         device), c0 * ncy * ncz, gi * K)
    return out


def pack_grid(grid: Grid, dtype=None, x_chunk: int | None = None,
              poly_basis: str | None = None) -> PackedGrid:
    """Per-cell polynomial coefficients of a Grid, on the grid's device.

    ``x_chunk``: pack in x-slabs of this many cells (``_pack_table``).

    ``poly_basis``: "monomial" or "chebyshev". Default (None):
    ``_default_basis``, Chebyshev for float32 packs of the Hermite methods
    (tricubic, triquintic), monomial otherwise.

    Value-method packs contract in float64 and cast the table to ``dtype``
    (default: the grid's dtype). Hermite-method packs contract in
    ``dtype``: with the fused basis-to-Chebyshev axis matrices every
    intermediate is a bounded Chebyshev coefficient, so float32 needs no
    float64 detour. The call is the span ``omgf.pack``.
    """
    dtype = dtype or grid.vals.dtype
    method = int(grid.interp_method)
    poly_basis = poly_basis or _default_basis(method, dtype)
    if poly_basis not in ("monomial", "chebyshev"):
        raise ValueError(f"unknown poly_basis {poly_basis!r}")
    with trace("omgf.pack"):
        coeffs = _pack_table([grid], dtype, poly_basis, x_chunk,
                             grid.vals.device)
        return PackedGrid(
            coeffs=coeffs.contiguous(),
            spacing=grid.spacing.to(dtype),
            origin=grid.origin.to(dtype),
            counts=grid.counts,
            degree=_DEGREES[method],
            back_power=grid_back_power(grid),
            oob_k=grid.oob_k,
            poly_basis=poly_basis,
        )


# ----------------------------------------------------------------------
# Evaluation
# ----------------------------------------------------------------------

def _tensor_poly(R, f, d, poly_basis):
    """Value and fraction-gradient of the cell polynomials R [..., d,d,d]
    (leading dims broadcast against f [..., 3]). Returns (P, grad [.., 3])."""
    px, py, pz = (_poly_powers(f[..., a], d, poly_basis) for a in range(3))
    dpx, dpy, dpz = (_poly_dpowers(f[..., a], d, poly_basis)
                     for a in range(3))
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


def _inputs(table, positions, scaling_factors):
    """Positions and scalings in the dtype and on the device of a pack."""
    dtype = table.coeffs.dtype
    positions = positions.to(dtype)
    return positions, torch.as_tensor(scaling_factors, dtype=dtype,
                                      device=positions.device)


def _gather_rows(table, positions):
    """Locate atoms and gather each one's cell row.

    Returns (pos, corner, inside, f, rows [..., N, width])."""
    pos, corner, inside, ixyz, f = locate(positions, table.spacing,
                                          table.origin, table.counts)
    cell = cell_index(ixyz, table.counts)
    rows = table.coeffs.index_select(0, cell.reshape(-1))
    return pos, corner, inside, f, rows.reshape(cell.shape + (-1,))


def _gather_window(table, positions, x_lo: int, x_count: int):
    """``_gather_rows`` on a table that holds the cells [x_lo, x_lo +
    x_count) along x (a rank's slab of a table split over x-cells).

    Returns (pos, corner, inside, owned, f, rows [..., N, width]): owned
    are the atoms inside whose cell the table holds; the others read a
    clamped row."""
    pos, corner, inside, ixyz, f = locate(positions, table.spacing,
                                          table.origin, table.counts)
    _, ncy, ncz = table.cell_counts
    local_x = ixyz[..., 0] - x_lo
    owned = (local_x >= 0) & (local_x < x_count) & inside
    cell = (local_x.clamp(0, x_count - 1) * ncy + ixyz[..., 1]) * ncz \
        + ixyz[..., 2]
    rows = table.coeffs.index_select(0, cell.reshape(-1))
    return pos, corner, inside, owned, f, rows.reshape(cell.shape + (-1,))


def evaluate_packed(packed: PackedGrid, positions,
                    scaling_factors) -> GridEval:
    """Energy and forces of atoms [..., N, 3] on one packed grid."""
    positions, scaling = _inputs(packed, positions, scaling_factors)
    pos, corner, inside, f, rows = _gather_rows(packed, positions)
    d = packed.degree
    R = rows.reshape(rows.shape[:-1] + (d, d, d))
    interp, grad_s = _tensor_poly(R, f, d, packed.poly_basis)
    return finish_single(interp, grad_s, packed.back_power, packed.spacing,
                         scaling, pos, corner, inside, packed.oob_k)


# ----------------------------------------------------------------------
# Multi-grid fusion: co-located grids share one gather
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultiPackedGrid(_FusedCells):
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
    poly_basis: str = "monomial"


def _check_fusable(packs, fields):
    """Raise unless the packs share ``fields`` and their geometry."""
    first = packs[0]
    for p in packs[1:]:
        if any(getattr(p, k) != getattr(first, k) for k in fields):
            raise ValueError(f"grids must share {'/'.join(fields)} to fuse")
        with trace("omgf.sync.fusable"):
            fusable = (torch.allclose(p.spacing, first.spacing)
                       and torch.allclose(p.origin, first.origin))
        if not fusable:
            raise ValueError("grids must be co-located (same spacing and "
                             "origin) to fuse — evaluation would use the "
                             "first grid's geometry for all")


def combine_packed_grids(packed_grids) -> MultiPackedGrid:
    """Fuse PackedGrids with identical geometry, degree and basis into one
    table [ncells, G*K]. The call is the span ``omgf.pack``."""
    with trace("omgf.pack"):
        _check_fusable(packed_grids,
                       ("counts", "degree", "oob_k", "poly_basis"))
        coeffs = torch.cat([p.coeffs for p in packed_grids], dim=1)
    first = packed_grids[0]
    return MultiPackedGrid(
        coeffs=coeffs,
        spacing=first.spacing,
        origin=first.origin,
        counts=first.counts,
        degree=first.degree,
        n_grids=len(packed_grids),
        back_powers=tuple(p.back_power for p in packed_grids),
        oob_k=first.oob_k,
        poly_basis=first.poly_basis,
    )


def pack_grids_fused(grids, dtype=None, x_chunk: int | None = None,
                     device=None) -> MultiPackedGrid:
    """Pack co-located grids of one interpolation method straight into
    one fused table [ncells, G*K] on ``device``, slab by slab.

    ``combine_packed_grids`` needs every per-grid pack resident beside the
    fused output (twice the table); here each grid's x-slabs (``x_chunk``
    cells, see ``_pack_table``) are packed from planes copied to
    ``device`` and written into the preallocated table, so the peak is the
    table plus one slab. The table equals
    ``combine_packed_grids([pack_grid(g, dtype) for g in grids])``; Hermite
    methods use ``pack_grid``'s default basis (Chebyshev in float32).
    """
    device = resolve_device(device)
    first = grids[0]
    method = int(first.interp_method)
    if method not in _DEGREES:
        raise ValueError(f"unsupported interpolation method {method}")
    _check_fusable(grids, ("counts", "interp_method", "oob_k"))
    dtype = dtype or first.vals.dtype
    poly_basis = _default_basis(method, dtype)
    out = _pack_table(grids, dtype, poly_basis, x_chunk, device)
    return MultiPackedGrid(
        coeffs=out,
        spacing=first.spacing.to(device, dtype),
        origin=first.origin.to(device, dtype),
        counts=first.counts,
        degree=_DEGREES[method],
        n_grids=len(grids),
        back_powers=tuple(grid_back_power(g) for g in grids),
        oob_k=first.oob_k,
        poly_basis=poly_basis,
    )


def _finish_multi(interp, grad_s, back_powers, spacing, scaling, pos,
                  corner, inside, oob_k, owned=None,
                  restrain: bool = True) -> GridEval:
    """The tail of the fused evaluators: from interpolated values
    [..., N, G] and fraction-gradients [..., N, G, 3] of G grids to summed
    energies and forces, the restraint applied once for the set.
    ``scaling`` is [G, N]. A rank of a sharded table counts the
    interpolation only of the atoms it ``owns`` (default: every atom
    inside the box), and the restraint only where ``restrain``."""
    dtype, device = interp.dtype, interp.device
    if any(bp != 0.0 for bp in back_powers):
        bps = const_tensor(tuple(back_powers), dtype, device)
        sign = torch.where(interp >= 0.0, 1.0, -1.0).to(dtype)
        a = interp.abs()
        act = (a > 1e-10) & (bps != 0.0)
        one = torch.ones_like(a)
        a_safe = torch.where(act, a, one)
        pf = torch.where(act, bps * lanewise(torch.pow, a_safe, bps - 1.0),
                         one)
        interp = torch.where(act, sign * lanewise(torch.pow, a_safe, bps),
                             interp)
        grad_s = grad_s * pf[..., None]

    grad_phys = grad_s / spacing                        # [..., N, G, 3]
    s_t = scaling.transpose(0, 1)                       # [N, G]
    counted = inside if owned is None else owned
    active = counted[..., None] & (s_t != 0.0)          # [..., N, G]
    zero = torch.zeros((), dtype=dtype, device=device)
    per_atom = torch.where(active, s_t * interp, zero).sum(-1)
    forces = -torch.where(active[..., None], s_t[..., None] * grad_phys,
                          zero).sum(-2)

    if restrain:
        dev = oob_deviation(pos, corner)
        oob = ~inside
        per_atom = per_atom + torch.where(
            oob, 0.5 * oob_k * (dev * dev).sum(-1), zero)
        forces = forces + torch.where(oob[..., None], -oob_k * dev, zero)
    return GridEval(per_atom.sum(-1), forces, per_atom)


def evaluate_multi(multi: MultiPackedGrid, positions,
                   scaling_factors) -> GridEval:
    """Evaluate all fused grids with one gather per atom: on the card the
    hand-written kernel (``cuda_packed_eval``), on the host its plain
    twin.

    Args:
      positions: [..., N, 3].
      scaling_factors: [G, N] per-grid per-atom scalings.

    Returns GridEval where per-atom energies/forces are summed over grids;
    the out-of-bounds restraint is applied once for the fused set.
    """
    positions, scaling = _inputs(multi, positions, scaling_factors)
    per_atom, forces = packed_eval(multi, positions, scaling)
    return GridEval(per_atom.sum(-1), forces, per_atom)


# ----------------------------------------------------------------------
# Hermite-packed grids: one row gather per atom, bounded basis
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HermitePackedGrid(_Cells):
    """Per-cell corner-derivative rows plus evaluation config."""

    coeffs: torch.Tensor          # [ncells, 8*D] (D = 8 or 27)
    spacing: torch.Tensor         # [3]
    origin: torch.Tensor          # [3]
    counts: tuple = (0, 0, 0)
    method: int = int(InterpolationMethod.TRIQUINTIC)
    back_power: float = 0.0
    oob_k: float = 0.0


def _pack_hermite_rows(derivs27, method, runtime_inv, inv_power, counts):
    nx, ny, nz = counts
    ncx, ncy, ncz = nx - 1, ny - 1, nz - 1
    D = derivs27
    if runtime_inv:
        D = apply_invpower(D, 1.0 / inv_power)
    if method == InterpolationMethod.TRICUBIC:
        D = D.index_select(-1, torch.as_tensor(TRICUBIC_DERIV_MAP,
                                               device=D.device))
    corners = [D[cx:cx + ncx, cy:cy + ncy, cz:cz + ncz]
               for cx, cy, cz in zip(_CORNER_CX, _CORNER_CY, _CORNER_CZ)]
    X = torch.stack(corners, dim=3)                 # [i, j, k, 8, D]
    return X.reshape(ncx * ncy * ncz, -1)


def pack_grid_hermite(grid: Grid, dtype=None) -> HermitePackedGrid:
    """Pack a Hermite-method Grid into per-cell corner-derivative rows."""
    method = int(grid.interp_method)
    if method not in _HERMITE_METHODS:
        raise ValueError("pack_grid_hermite is for tricubic/triquintic")
    if grid.derivs is None:
        raise ValueError("Hermite methods need precomputed derivatives")
    dtype = dtype or grid.vals.dtype
    coeffs = _pack_hermite_rows(grid.derivs.to(dtype), method,
                                grid_runtime_inv(grid), grid.inv_power,
                                grid.counts)
    return HermitePackedGrid(
        coeffs=coeffs.contiguous(),
        spacing=grid.spacing.to(dtype),
        origin=grid.origin.to(dtype),
        counts=grid.counts,
        method=method,
        back_power=grid_back_power(grid),
        oob_k=grid.oob_k,
    )


def evaluate_hermite_packed(hp: HermitePackedGrid, positions,
                            scaling_factors) -> GridEval:
    """Energy and forces of atoms [..., N, 3] on one Hermite-packed grid
    (same clamping, restraint and back-transform as evaluate_packed)."""
    positions, scaling = _inputs(hp, positions, scaling_factors)
    pos, corner, inside, f, rows = _gather_rows(hp, positions)
    X = rows.reshape(rows.shape[:-1] + (8, -1))         # [..., N, 8, D]
    interp, grad_s = _hermite_tensor_eval(X, f,
                                          *HERMITE_FAMILIES[hp.method])
    return finish_single(interp, grad_s, hp.back_power, hp.spacing, scaling,
                         pos, corner, inside, hp.oob_k)


@dataclasses.dataclass(frozen=True)
class MultiHermitePackedGrid(_FusedCells):
    """G Hermite-packed grids fused into one row table [ncells, G*8*D]:
    one gather per atom serves every co-located grid in the bounded-basis
    representation."""

    coeffs: torch.Tensor
    spacing: torch.Tensor
    origin: torch.Tensor
    counts: tuple = (0, 0, 0)
    method: int = int(InterpolationMethod.TRIQUINTIC)
    n_grids: int = 1
    back_powers: tuple = ()
    oob_k: float = 0.0


def combine_hermite_packed(hps) -> MultiHermitePackedGrid:
    """Fuse HermitePackedGrids with identical geometry and method."""
    _check_fusable(hps, ("counts", "method", "oob_k"))
    first = hps[0]
    return MultiHermitePackedGrid(
        coeffs=torch.cat([p.coeffs for p in hps], dim=1),
        spacing=first.spacing, origin=first.origin, counts=first.counts,
        method=first.method, n_grids=len(hps),
        back_powers=tuple(p.back_power for p in hps), oob_k=first.oob_k)


def evaluate_hermite_multi(multi: MultiHermitePackedGrid, positions,
                           scaling_factors) -> GridEval:
    """All fused Hermite-packed grids with one gather per atom.

    ``scaling_factors``: [G, N]. The restraint applies once per fused set
    (same convention as evaluate_multi)."""
    positions, scaling = _inputs(multi, positions, scaling_factors)
    pos, corner, inside, f, rows = _gather_rows(multi, positions)
    X = rows.reshape(rows.shape[:-1] + (multi.n_grids, 8, -1))
    interp, grad_s = _hermite_tensor_eval(
        X, f, *HERMITE_FAMILIES[multi.method])   # [..., N, G(, 3)]
    return _finish_multi(interp, grad_s, multi.back_powers, multi.spacing,
                         scaling, pos, corner, inside, multi.oob_k)
