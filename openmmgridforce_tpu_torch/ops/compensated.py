"""Compensated (double-float32) packed-grid evaluation: the accuracy tier
that breaks the plain-float32 evaluation floor without float64 on the
device.

The port of the JAX package's ``ops/compensated.py``. Plain float32
evaluation carries an error floor near receptor cores, from the cell
fraction formed of coordinates of a hundred cells at float32 ulp and from
the rounding of the coefficient contraction. This tier removes both:

  * per-cell Chebyshev coefficients are packed in float64 on the host and
    stored as (hi, lo) float32 pairs fused into one row table, so
    evaluation is still one row gather per atom;
  * the cell fraction, the Chebyshev recurrences and every contraction run
    in double-word float32 arithmetic (``ops/twofloat.py``).

The result is limited by the float32 storage of the grid data and the
final per-atom rounding (~6e-8 relative), at about ten times the
arithmetic of the plain tier: it is for accuracy-gated evaluations (pose
scoring, parity gates), not the MD step. Clamping, the restraint, the
inverse-power back-transform and the masking of inert atoms follow
``ops/packed.evaluate_packed``.

Pure tensor code: the table lives on the device of the grid it packs, and
evaluation runs there. As ``ops/twofloat.py`` says, do not apply
``torch.compile`` or Triton to it. ``GridEval.energy`` is per leading
batch entry ([...]), summed over atoms by a double-word tree (the JAX
function returns the sum over the whole batch).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..grid import Grid
from .interpolate import GridEval, const_tensor
from .packed import _Cells, pack_grid
from .twofloat import (df, df_add, df_add_f, df_from_f64, df_mul, df_mul_f,
                       df_scale_pow2, df_sub, df_sum, df_to, df_where,
                       fast_two_sum, two_sum)


@dataclasses.dataclass(frozen=True)
class CompensatedPackedGrid(_Cells):
    """Per-cell Chebyshev coefficients as fused (hi | lo) float32 rows.

    ``coeffs`` is [ncells, 2K]: columns [0, K) hold the high words,
    [K, 2K) the low words of the float64-packed coefficients, so one row
    gather serves both. The geometry is carried as df pairs, so the cell
    fraction is formed to ~1e-14 relative."""

    coeffs: torch.Tensor               # [ncells, 2K] f32
    origin_hi: torch.Tensor            # [3] f32
    origin_lo: torch.Tensor
    inv_spacing_hi: torch.Tensor
    inv_spacing_lo: torch.Tensor
    corner_hi: torch.Tensor            # spacing * (counts - 1)
    corner_lo: torch.Tensor
    spacing: torch.Tensor              # [3] f32
    counts: tuple = (0, 0, 0)
    degree: int = 2
    back_power: float = 0.0
    oob_k: float = 0.0


def pack_grid_compensated(grid: Grid, x_chunk: int | None = None,
                          origin=None, spacing=None
                          ) -> CompensatedPackedGrid:
    """Pack a Grid into compensated (hi | lo) Chebyshev rows on the grid's
    device.

    The packing runs in float64 on the host (``pack_grid`` with the
    Chebyshev basis, each coefficient exact to ~2^-52), then each
    coefficient is split into a float32 pair. All four interpolation
    methods; the Hermite ones need ``grid.derivs``.

    ``origin`` / ``spacing``: exact float64 geometry. A float32 Grid
    carries its geometry rounded to float32, which shifts the cell
    coordinate by ~1e-7 t cells on large grids; pass the float64 values
    where the caller has them.
    """
    device = grid.vals.device
    host = torch.float64
    g64 = grid.with_(
        vals=grid.vals.to("cpu", host), spacing=grid.spacing.to("cpu", host),
        origin=grid.origin.to("cpu", host),
        derivs=None if grid.derivs is None else grid.derivs.to("cpu", host))
    p64 = pack_grid(g64, dtype=host, x_chunk=x_chunk,
                    poly_basis="chebyshev")
    hi, lo = df_from_f64(p64.coeffs.numpy())
    rows = np.concatenate([hi, lo], axis=1)
    sp = np.asarray(g64.spacing.numpy() if spacing is None else spacing,
                    np.float64)
    o = np.asarray(g64.origin.numpy() if origin is None else origin,
                   np.float64)
    o_hi, o_lo = df_from_f64(o)
    isp_hi, isp_lo = df_from_f64(1.0 / sp)
    # the float64 reference's inside test compares (pos - origin) against
    # fl64(spacing * (counts - 1)); carry that corner as a df pair
    c_hi, c_lo = df_from_f64(sp * (np.asarray(grid.counts) - 1))

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return CompensatedPackedGrid(
        coeffs=dev(rows), origin_hi=dev(o_hi), origin_lo=dev(o_lo),
        inv_spacing_hi=dev(isp_hi), inv_spacing_lo=dev(isp_lo),
        corner_hi=dev(c_hi), corner_lo=dev(c_lo),
        spacing=dev(sp.astype(np.float32)), counts=tuple(grid.counts),
        degree=p64.degree, back_power=p64.back_power, oob_k=p64.oob_k)


# ----------------------------------------------------------------------
# df Chebyshev basis and contractions
# ----------------------------------------------------------------------

def _cheb_df(f, d):
    """T_p(2f-1) and d/df T_p(2f-1) = 2p U_{p-1}(2f-1) for p < d, in df
    arithmetic; ``f`` a df pair. Returns two lists of d df pairs."""
    one = df(torch.ones_like(f[0]))
    zero = df(torch.zeros_like(f[0]))
    u = df_add_f(df_scale_pow2(f, 2.0), -1.0)
    T = [one, u]
    for _ in range(2, d):
        T.append(df_sub(df_scale_pow2(df_mul(u, T[-1]), 2.0), T[-2]))
    U = [one, df_scale_pow2(u, 2.0)]
    for _ in range(2, max(d - 1, 2)):
        U.append(df_sub(df_scale_pow2(df_mul(u, U[-1]), 2.0), U[-2]))
    dT = [zero]
    for p in range(1, d):
        dT.append(df_mul_f(U[p - 1], torch.full_like(f[0], 2.0 * p)))
    return T[:d], dT[:d]


def _df_contract_last(R_hi, R_lo, w, d):
    """Contract the last axis of an (hi, lo) coefficient tensor with d df
    weights (each broadcastable to the result). Returns an (hi, lo)
    pair."""
    extra = R_hi.dim() - 1 - w[0][0].dim()

    def bcast(x):
        hi, lo = x
        for _ in range(extra):
            hi, lo = hi[..., None], lo[..., None]
        return hi, lo

    acc = df_mul((R_hi[..., 0], R_lo[..., 0]), bcast(w[0]))
    for r in range(1, d):
        acc = df_add(acc, df_mul((R_hi[..., r], R_lo[..., r]), bcast(w[r])))
    return acc


def evaluate_compensated(cp: CompensatedPackedGrid, positions,
                         scaling_factors) -> GridEval:
    """Energy and forces of atoms [..., N, 3] through the compensated
    representation.

    ``positions`` float64 are split exactly into df pairs; float32 ones
    get zero low words (the fraction and contraction rounding are still
    removed). The semantics are ``ops.packed.evaluate_packed``'s."""
    device = cp.coeffs.device
    positions = torch.as_tensor(positions, device=device)
    pos_hi = positions.to(torch.float32)
    if positions.dtype == torch.float64:
        pos_lo = (positions - pos_hi.to(torch.float64)).to(torch.float32)
    else:
        pos_lo = torch.zeros_like(pos_hi)
    scaling = torch.as_tensor(scaling_factors, dtype=torch.float32,
                              device=device)
    d = cp.degree
    K = d ** 3

    # df cell coordinates: r = pos - origin, t = r / spacing
    f_ax, ix_ax, inside = [], [], None
    for ax in range(3):
        r = df_sub((pos_hi[..., ax], pos_lo[..., ax]),
                   (cp.origin_hi[ax], cp.origin_lo[ax]))
        t = df_mul(r, (cp.inv_spacing_hi[ax], cp.inv_spacing_lo[ax]))
        ix = torch.floor(t[0]).to(torch.int64).clamp(0, cp.counts[ax] - 2)
        # f = t - ix: 2Sum against the exact cell index, then clamped to
        # [0, 1] (a high word outside zeroes the low one)
        fh, e = two_sum(t[0], -ix.to(torch.float32))
        f = fast_two_sum(fh, e + t[1])
        out = (f[0] < 0.0) | (f[0] > 1.0)
        f = (f[0].clamp(0.0, 1.0),
             torch.where(out, torch.zeros_like(f[1]), f[1]))
        # the float64 reference's inside test, (pos - origin) against
        # fl64(spacing * (counts - 1)): the df difference carries ~1e-14
        # relative rounding, so an atom exactly on a face is biased
        # inside by 2e-13 of the corner (the reference's <=)
        over = df_sub(r, (cp.corner_hi[ax], cp.corner_lo[ax]))
        tol = cp.corner_hi[ax] * 2e-13
        in_ax = (r[0] + r[1] >= -tol) & (over[0] + over[1] <= tol)
        inside = in_ax if inside is None else inside & in_ax
        f_ax.append(f)
        ix_ax.append(ix)

    # the restraint in plain float32 (well conditioned outside the box)
    pos_rel = (pos_hi + pos_lo) - (cp.origin_hi + cp.origin_lo)
    counts = const_tensor(tuple(cp.counts), torch.float32, device)
    corner = cp.spacing * (counts - 1.0)

    _, ncy, ncz = cp.cell_counts
    cell = (ix_ax[0] * ncy + ix_ax[1]) * ncz + ix_ax[2]
    rows = cp.coeffs.index_select(0, cell.reshape(-1))
    rows = rows.reshape(cell.shape + (-1,))
    R_hi = rows[..., :K].reshape(rows.shape[:-1] + (d, d, d))
    R_lo = rows[..., K:2 * K].reshape(rows.shape[:-1] + (d, d, d))

    Tx, dTx = _cheb_df(f_ax[0], d)
    Ty, dTy = _cheb_df(f_ax[1], d)
    Tz, dTz = _cheb_df(f_ax[2], d)

    # separable df contraction, sharing partials
    A = _df_contract_last(R_hi, R_lo, Tz, d)            # [..., d, d]
    Adz = _df_contract_last(R_hi, R_lo, dTz, d)
    By = _df_contract_last(A[0], A[1], Ty, d)           # [..., d]
    Bdy = _df_contract_last(A[0], A[1], dTy, d)
    Bdz = _df_contract_last(Adz[0], Adz[1], Ty, d)
    interp = _df_contract_last(By[0], By[1], Tx, d)     # [...]
    gx = _df_contract_last(By[0], By[1], dTx, d)
    gy = _df_contract_last(Bdy[0], Bdy[1], Tx, d)
    gz = _df_contract_last(Bdz[0], Bdz[1], Tx, d)

    if cp.back_power != 0.0:
        n = cp.back_power
        sign = torch.where(interp[0] >= 0.0, 1.0, -1.0).to(torch.float32)
        a = (interp[0].abs(), interp[1] * sign)
        active_bp = a[0] > 1e-10
        a_hi = torch.where(active_bp, a[0], torch.ones_like(a[0]))
        a_lo = torch.where(active_bp, a[1], torch.zeros_like(a[1]))
        # (a_hi + a_lo)^n = a_hi^n (1 + n a_lo / a_hi) to first order; the
        # neglected term is O((a_lo / a_hi)^2) ~ 1e-15 relative
        p_main = a_hi ** n
        p_corr = p_main * (n * (a_lo / a_hi))
        val = fast_two_sum(p_main, p_corr)
        val = (val[0] * sign, val[1] * sign)
        pf = n * a_hi ** (n - 1.0)          # float32 is ample for forces
        interp = df_where(active_bp, val, interp)
        gx = df_where(active_bp, df_mul_f(gx, pf), gx)
        gy = df_where(active_bp, df_mul_f(gy, pf), gy)
        gz = df_where(active_bp, df_mul_f(gz, pf), gz)

    grads = [df_mul(g, (cp.inv_spacing_hi[ax], cp.inv_spacing_lo[ax]))
             for ax, g in enumerate((gx, gy, gz))]
    energy_in = df_mul_f(interp, scaling)
    force_in = torch.stack([-scaling * df_to(g) for g in grads], dim=-1)

    zero = torch.zeros((), dtype=torch.float32, device=device)
    dev = torch.where(pos_rel < 0.0, pos_rel,
                      torch.where(pos_rel > corner, pos_rel - corner, zero))
    energy_oob = 0.5 * cp.oob_k * (dev * dev).sum(-1)
    force_oob = -cp.oob_k * dev

    active = inside & (scaling != 0.0)
    per_atom = df_where(active, energy_in, df(energy_oob))
    forces = torch.where(active[..., None], force_in, force_oob)
    return GridEval(df_to(df_sum(per_atom)), forces, df_to(per_atom))
