"""Reference-platform (CPU/double) evaluation semantics, as an option.

The port of the JAX package's ``ops/reference_semantics.py``: the
reference platform's kernel (ReferenceGridForceKernels.cpp:646-1121),
where it disagrees with the CUDA conventions of ``ops/interpolate.py``:

  * Q2: the cell index is not clamped to counts-2; at the exact upper
    grid face the atom lands in a one-past-the-last cell with fraction 0
    (``(int)(pi/spacing)``, :710-717).
  * Q4: the inverse-power back-transform fires on ``inv_power > 0`` alone
    and is a plain ``pow``: no mode check, no sign handling, no 1e-10
    dead zone (:785-796).
  * the tricubic branch (:796-893) interpolates from values only, with
    centred finite-difference corner derivatives, through an x -> y -> z
    cascade of cubic Hermite interpolations whose gradient cross-terms the
    reference drops (ported literally).
  * Q12: the triquintic branch converts local gradients to physical ones
    by multiplying by the spacing (:992-997).
  * flat-index neighbour reads: at a z (or y) face the trilinear and
    tricubic stencils read the next row of the flattened array rather than
    clamping per axis. Indices are clipped to the array only where the C++
    would read outside it (undefined behaviour there).

Q1 (forces written to the loop index) belongs to the compat API's
Context. The stencils reuse ``ops/interpolate.py``'s basis, corner
indices and Hermite evaluation; only the reference's own geometry (the
unclamped cell) and its flat reads are here. Pure tensor code on the
device of its inputs.
"""

from __future__ import annotations

import torch

from ..grid import Grid, InterpolationMethod, InvPowerMode
from . import basis
from .chain_rules import apply_invpower
from .interpolate import (HERMITE_FAMILIES, GridEval, _flat_corner_indices,
                          _hermite_tensor_eval, _interp_bspline,
                          const_tensor, grid_runtime_inv, oob_deviation)


def _gv(flat, idx):
    """Flat gather with the index clipped to the array (in place of the
    C++'s raw reads)."""
    return flat[idx.clamp(0, flat.shape[0] - 1)]


def _flat_base(grid, ixyz):
    _, ny, nz = grid.counts
    return ixyz[..., 0] * (ny * nz) + ixyz[..., 1] * nz + ixyz[..., 2]


def _ref_trilinear(grid: Grid, ixyz, f):
    """:1016-1084: flat-index corner arithmetic, fraction complements."""
    _, ny, nz = grid.counts
    nyz = ny * nz
    flat = grid.vals.reshape(-1)
    im = _flat_base(grid, ixyz)
    imp = im + nz
    ip = im + nyz
    ipp = ip + nz

    vmmm, vmmp = _gv(flat, im), _gv(flat, im + 1)
    vmpm, vmpp = _gv(flat, imp), _gv(flat, imp + 1)
    vpmm, vpmp = _gv(flat, ip), _gv(flat, ip + 1)
    vppm, vppp = _gv(flat, ipp), _gv(flat, ipp + 1)

    fx, fy, fz = f.unbind(-1)
    ax, ay, az = 1.0 - fx, 1.0 - fy, 1.0 - fz

    vmm = az * vmmm + fz * vmmp
    vmp = az * vmpm + fz * vmpp
    vpm = az * vpmm + fz * vpmp
    vpp = az * vppm + fz * vppp
    vm = ay * vmm + fy * vmp
    vp = ay * vpm + fy * vpp
    interp = ax * vm + fx * vp

    dx = -vm + vp
    dy = (-vmm + vmp) * ax + (-vpm + vpp) * fx
    dz = ((-vmmm + vmmp) * ay + (-vmpm + vmpp) * fy) * ax + \
         ((-vpmm + vpmp) * ay + (-vppm + vppp) * fy) * fx
    return interp, torch.stack([dx, dy, dz], dim=-1)


def _hermite3(t):
    """(h00, h01, h10, h11) and their derivatives at t."""
    h, g = basis.hermite3_weights(t), basis.hermite3_derivs(t)
    return ((h[..., 0, 0], h[..., 0, 1], h[..., 1, 0], h[..., 1, 1]),
            (g[..., 0, 0], g[..., 0, 1], g[..., 1, 0], g[..., 1, 1]))


def _ref_tricubic_fd(grid: Grid, ixyz, f):
    """:796-893: on-the-fly finite-difference tricubic, ported literally
    (the dropped gradient cross-terms included)."""
    nx, ny, nz = grid.counts
    nyz = ny * nz
    sx, sy, sz = grid.spacing.unbind(0)
    flat = grid.vals.reshape(-1)
    ix, iy, iz = ixyz.unbind(-1)
    im = _flat_base(grid, ixyz)
    imp = im + nz
    ip = im + nyz
    ipp = ip + nz
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)

    f000, f001 = _gv(flat, im), _gv(flat, im + 1)
    f010, f011 = _gv(flat, imp), _gv(flat, imp + 1)
    f100, f101 = _gv(flat, ip), _gv(flat, ip + 1)
    f110, f111 = _gv(flat, ipp), _gv(flat, ipp + 1)

    in_x = (ix > 0) & (ix < nx - 1)

    def fd_x(row_off):
        # centred differences around (ix, .) and (ix+1, .)
        lo = _gv(flat, im - nyz + row_off)
        hi = _gv(flat, ip + row_off)
        d0 = torch.where(in_x, (hi - lo) / (2.0 * sx), zero)
        lo1 = _gv(flat, im + row_off)
        hi1 = _gv(flat, ip + nyz + row_off)
        d1 = torch.where(in_x, (hi1 - lo1) / (2.0 * sx), zero)
        return d0, d1

    dx000, dx100 = fd_x(0)
    dx001, dx101 = fd_x(1)
    dx010, dx110 = fd_x(nz)
    dx011, dx111 = fd_x(nz + 1)

    fx, fy, fz = f.unbind(-1)
    (h00x, h01x, h10x, h11x), (dh00x, dh01x, dh10x, dh11x) = _hermite3(fx)

    def xline(fa, fb, da, db):
        return h00x * fa + h01x * fb + h10x * da * sx + h11x * db * sx

    def dxline(fa, fb, da, db):
        return dh00x * fa + dh01x * fb + dh10x * da * sx + dh11x * db * sx

    v00 = xline(f000, f100, dx000, dx100)
    v01 = xline(f001, f101, dx001, dx101)
    v10 = xline(f010, f110, dx010, dx110)
    v11 = xline(f011, f111, dx011, dx111)
    dv00 = dxline(f000, f100, dx000, dx100)
    dv01 = dxline(f001, f101, dx001, dx101)
    dv10 = dxline(f010, f110, dx010, dx110)
    dv11 = dxline(f011, f111, dx011, dx111)

    in_y = (iy > 0) & (iy < ny - 1)
    # one-sided y-derivative estimates mixing interpolated values
    # (reference :843-846, ported verbatim)
    dy00 = torch.where(in_y, (v10 - (h00x * _gv(flat, im - nz)
                                     + h01x * _gv(flat, ip - nz))) / sy,
                       zero)
    dy01 = torch.where(in_y, (v11 - (h00x * _gv(flat, im + 1 - nz)
                                     + h01x * _gv(flat, ip + 1 - nz))) / sy,
                       zero)
    dy10 = torch.where(in_y, ((h00x * _gv(flat, im + 2 * nz)
                               + h01x * _gv(flat, ip + 2 * nz)) - v00) / sy,
                       zero)
    dy11 = torch.where(in_y, ((h00x * _gv(flat, im + 1 + 2 * nz)
                               + h01x * _gv(flat, ip + 1 + 2 * nz)) - v01)
                       / sy, zero)

    (h00y, h01y, h10y, h11y), (dh00y, dh01y, dh10y, dh11y) = _hermite3(fy)

    v0 = h00y * v00 + h01y * v10 + h10y * dy00 * sy + h11y * dy10 * sy
    v1 = h00y * v01 + h01y * v11 + h10y * dy01 * sy + h11y * dy11 * sy
    dvdx_0 = h00y * dv00 + h01y * dv10
    dvdx_1 = h00y * dv01 + h01y * dv11
    dvdy = (dh00y * v00 + dh01y * v10
            + dh10y * dy00 * sy + dh11y * dy10 * sy)

    in_z = (iz > 0) & (iz < nz - 1)
    dz0 = torch.where(
        in_z,
        (v1 - (h00y * (h00x * _gv(flat, im - 1) + h01x * _gv(flat, ip - 1))
               + h01y * (h00x * _gv(flat, imp - 1)
                         + h01x * _gv(flat, ipp - 1)))) / sz, zero)
    dz1 = torch.where(
        in_z,
        ((h00y * (h00x * _gv(flat, im + 2) + h01x * _gv(flat, ip + 2))
          + h01y * (h00x * _gv(flat, imp + 2)
                    + h01x * _gv(flat, ipp + 2))) - v0) / sz, zero)

    (h00z, h01z, h10z, h11z), (dh00z, dh01z, dh10z, dh11z) = _hermite3(fz)

    interp = h00z * v0 + h01z * v1 + h10z * dz0 * sz + h11z * dz1 * sz
    dvdx = h00z * dvdx_0 + h01z * dvdx_1
    dvdz = (dh00z * v0 + dh01z * v1
            + dh10z * dz0 * sz + dh11z * dz1 * sz)
    return interp, torch.stack([dvdx, dvdy, dvdz], dim=-1)


def _ref_triquintic(grid: Grid, ixyz, f):
    """The default triquintic stencil at the unclamped cell, its corner
    reads clipped to the grid."""
    idx = _flat_corner_indices(grid, ixyz).clamp(0, grid.num_points - 1)
    X = grid.derivs.reshape(-1, 27)[idx]
    if grid_runtime_inv(grid):
        X = apply_invpower(X, 1.0 / grid.inv_power)
    return _hermite_tensor_eval(
        X, f, *HERMITE_FAMILIES[int(InterpolationMethod.TRIQUINTIC)])


def evaluate_grid_reference(grid: Grid, positions,
                            scaling_factors) -> GridEval:
    """Reference-platform semantics for positions [..., N, 3]: unclamped
    cell index (Q2), ``inv_power > 0`` literal-``pow`` back-transform (Q4),
    on-the-fly FD tricubic, triquintic gradient times spacing (Q12),
    unscaled restraint. Float64 grids and positions reproduce the
    reference within its expression order."""
    dtype = grid.vals.dtype
    positions = torch.as_tensor(positions, dtype=dtype,
                                device=grid.vals.device)
    scaling = torch.as_tensor(scaling_factors, dtype=dtype,
                              device=positions.device)
    pos = positions - grid.origin
    counts = const_tensor(tuple(grid.counts), dtype, pos.device)
    corner = grid.spacing * (counts - 1.0)
    inside = ((pos >= 0.0) & (pos <= corner)).all(-1)

    t = pos / grid.spacing
    # (int) truncation, no clamp to counts-2 (Q2); clipped only to keep the
    # index arithmetic in range for atoms outside (whose values the
    # ``inside`` mask discards)
    top = const_tensor(tuple(c - 1 for c in grid.counts), torch.int64,
                       pos.device)
    ixyz = torch.minimum(torch.floor(t).to(torch.int64).clamp_min(0), top)
    f = t - ixyz

    method = grid.interp_method
    to_phys = 1.0 / grid.spacing
    if method == InterpolationMethod.BSPLINE:
        # the per-axis clamped stencil of the default kernels around the
        # unclamped cell, with no stencil transform (the reference has none)
        interp, grad_s = _interp_bspline(
            grid.with_(inv_power_mode=int(InvPowerMode.NONE)), ixyz, f)
    elif method == InterpolationMethod.TRICUBIC:
        # values only: no derivative block needed
        interp, grad_s = _ref_tricubic_fd(grid, ixyz, f)
    elif method == InterpolationMethod.TRIQUINTIC:
        if grid.derivs is None:
            raise ValueError("reference triquintic requires precomputed "
                             "derivatives (GridForce docstring, "
                             "ReferenceGridForceKernels.cpp:910-913)")
        interp, grad_s = _ref_triquintic(grid, ixyz, f)
        to_phys = grid.spacing          # Q12: multiply, don't divide
    else:
        interp, grad_s = _ref_trilinear(grid, ixyz, f)

    # Q4: literal pow() back-transform on inv_power > 0, no mode check,
    # no sign handling, no dead zone (:785-796, :858-868, :1060-1079)
    n = float(grid.inv_power)
    if n > 0.0:
        base = interp
        interp = base ** n
        grad_s = grad_s * (n * base ** (n - 1.0))[..., None]

    grad_phys = grad_s * to_phys
    energy_in = scaling * interp
    force_in = -scaling[..., None] * grad_phys

    dev = oob_deviation(pos, corner)
    energy_oob = 0.5 * grid.oob_k * (dev * dev).sum(-1)
    force_oob = -grid.oob_k * dev

    active = inside & (scaling != 0.0)
    per_atom = torch.where(active, energy_in, energy_oob)
    forces = torch.where(active[..., None], force_in, force_oob)
    return GridEval(per_atom.sum(-1), forces, per_atom)
