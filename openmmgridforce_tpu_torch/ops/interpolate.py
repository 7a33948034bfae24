"""Grid interpolation in the reference layout: energies and analytic forces
of ligand atoms on an unpacked Grid, for all four methods.

Semantics (shared with the packed evaluators, which import the helpers
here):
  * cell index clamped to [0, counts-2], fraction clamped to [0, 1];
  * RUNTIME inverse-power transforms the stencil values (trilinear,
    B-spline) or all 27 corner derivatives by the exact chain rule
    (tricubic, triquintic) before interpolation;
  * common back-transform sign(v)|v|^n with the gradient's chain rule
    afterwards, with a 1e-10 dead zone;
  * atoms outside the box get an unscaled harmonic restraint
    E = 1/2 k d^2 per axis;
  * atoms with zero scaling factor contribute nothing (they fall into the
    restraint branch with zero deviation).

Tricubic and triquintic are evaluated in tensor-product Hermite form,

    P(s) = sum_{m, c} Hx[mx,cx](sx) Hy[my,cy](sy) Hz[mz,cz](sz) D^m f(corner c)

the same unique polynomial as the coefficient-matrix form, with bounded
basis weights.

Positions may carry any leading batch dimensions, [..., N, 3]; per-atom
scalings are shared across them. All functions are dtype-generic.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..grid import Grid, InterpolationMethod, InvPowerMode
from . import basis
from .chain_rules import apply_invpower, invpower_value
from .derivatives27 import DERIV_ORDERS, TRICUBIC_DERIV_MAP
from .lanewise import lanewise


class GridEval(NamedTuple):
    energy: torch.Tensor           # [...]: total grid energy
    forces: torch.Tensor           # [..., N, 3]
    per_atom_energy: torch.Tensor  # [..., N]


# Corner enumeration: c = cx + 2*cy + 4*cz.
_CORNER_CX = (0, 1, 0, 1, 0, 1, 0, 1)
_CORNER_CY = (0, 0, 1, 1, 0, 0, 1, 1)
_CORNER_CZ = (0, 0, 0, 0, 1, 1, 1, 1)

# Per-axis derivative orders for each of the 27 slots.
_AX = tuple(o[0] for o in DERIV_ORDERS)
_AY = tuple(o[1] for o in DERIV_ORDERS)
_AZ = tuple(o[2] for o in DERIV_ORDERS)

# Tricubic: orders of the 8 mapped derivatives {f,fx,fy,fz,fxy,fxz,fyz,fxyz}.
_AX3 = tuple(_AX[i] for i in TRICUBIC_DERIV_MAP)
_AY3 = tuple(_AY[i] for i in TRICUBIC_DERIV_MAP)
_AZ3 = tuple(_AZ[i] for i in TRICUBIC_DERIV_MAP)

HERMITE_FAMILIES = {
    int(InterpolationMethod.TRICUBIC):
        (basis.hermite3_weights, basis.hermite3_derivs, _AX3, _AY3, _AZ3),
    int(InterpolationMethod.TRIQUINTIC):
        (basis.hermite5_weights, basis.hermite5_derivs, _AX, _AY, _AZ),
}


@functools.lru_cache(maxsize=None)
def _index_tensor(values: tuple, device):
    """A cached int64 tensor on ``device``: static gather indices are
    uploaded once, not on every evaluation."""
    return torch.tensor(values, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def const_tensor(values: tuple, dtype, device):
    """A cached tensor of static values on ``device``: uploaded once, so a
    step that reads it can be recorded into a CUDA graph (an upload in a
    capture would synchronise with the host)."""
    return torch.tensor(values, dtype=dtype, device=device)


# ----------------------------------------------------------------------
# Geometry and the common tail of every single-grid evaluator
# ----------------------------------------------------------------------

def locate(positions, spacing, origin, counts):
    """Box test, clamped cell index and fraction of positions [..., 3].

    Returns (pos, corner, inside [...], ixyz [..., 3], f [..., 3])."""
    pos = positions - origin
    fcounts = const_tensor(tuple(counts), spacing.dtype, pos.device)
    corner = spacing * (fcounts - 1.0)
    inside = ((pos >= 0.0) & (pos <= corner)).all(-1)
    t = pos / spacing
    hi = _index_tensor(tuple(c - 2 for c in counts), pos.device)
    ixyz = torch.minimum(torch.floor(t).to(torch.int64).clamp_min(0), hi)
    f = (t - ixyz).clamp(0.0, 1.0)
    return pos, corner, inside, ixyz, f


def cell_index(ixyz, counts):
    """Flat index of the cell with lower corner ixyz [..., 3]."""
    ncy, ncz = counts[1] - 1, counts[2] - 1
    return (ixyz[..., 0] * ncy + ixyz[..., 1]) * ncz + ixyz[..., 2]


def oob_deviation(pos, corner):
    zero = torch.zeros_like(pos)
    return torch.where(pos < 0.0, pos,
                       torch.where(pos > corner, pos - corner, zero))


def finish_single(interp, grad_s, back_power, spacing, scaling, pos, corner,
                  inside, oob_k) -> GridEval:
    """From the interpolated value [..., N] and its fraction-gradient
    [..., N, 3] to energies and forces: the inverse-power back-transform
    (``back_power`` 0 disables it), the scaling, and the restraint for atoms
    outside the box."""
    if back_power != 0.0:
        n = back_power
        sign = torch.where(interp >= 0.0, 1.0, -1.0).to(interp.dtype)
        a = interp.abs()
        active = a > 1e-10
        a_safe = torch.where(active, a, torch.ones_like(a))
        pf = n * lanewise(torch.pow, a_safe, n - 1.0)
        interp = torch.where(active, sign * lanewise(torch.pow, a_safe, n),
                             interp)
        grad_s = torch.where(active[..., None], grad_s * pf[..., None],
                             grad_s)

    grad_phys = grad_s / spacing
    energy_in = scaling * interp
    force_in = -scaling[..., None] * grad_phys

    dev = oob_deviation(pos, corner)
    energy_oob = 0.5 * oob_k * (dev * dev).sum(-1)
    force_oob = -oob_k * dev

    active = inside & (scaling != 0.0)
    per_atom = torch.where(active, energy_in, energy_oob)
    forces = torch.where(active[..., None], force_in, force_oob)
    return GridEval(per_atom.sum(-1), forces, per_atom)


def grid_back_power(grid) -> float:
    """The back-transform exponent of a Grid: its inverse power when a
    mode is set, else 0 (``inv_power == 0`` disables the transform even
    with a mode set: n = 0 would map every value to +-1)."""
    if grid.inv_power_mode in (InvPowerMode.RUNTIME, InvPowerMode.STORED):
        return float(grid.inv_power)
    return 0.0


def grid_runtime_inv(grid) -> bool:
    """Whether the stencil is transformed before interpolation."""
    return (grid.inv_power_mode == InvPowerMode.RUNTIME
            and grid.inv_power != 0.0)


# ----------------------------------------------------------------------
# Method implementations: each returns (interpolated [..., N],
# grad_s [..., N, 3]) with grad_s the gradient w.r.t. the cell fraction.
# ----------------------------------------------------------------------

def _flat_corner_indices(grid: Grid, ixyz):
    """Flat point indices of the 8 cell corners, [..., N, 8]."""
    _, ny, nz = grid.counts
    base = (ixyz[..., 0] * (ny * nz) + ixyz[..., 1] * nz
            + ixyz[..., 2])[..., None]
    offs = tuple(cx * ny * nz + cy * nz + cz for cx, cy, cz in
                 zip(_CORNER_CX, _CORNER_CY, _CORNER_CZ))
    return base + _index_tensor(offs, base.device)


def _interp_trilinear(grid: Grid, ixyz, f):
    v = grid.vals.reshape(-1)[_flat_corner_indices(grid, ixyz)]  # [.., 8]
    if grid_runtime_inv(grid):
        v = invpower_value(v, 1.0 / grid.inv_power)

    fx, fy, fz = f.unbind(-1)
    ox, oy, oz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    vmmm, vpmm, vmpm, vppm, vmmp, vpmp, vmpp, vppp = v.unbind(-1)

    vmm = oz * vmmm + fz * vmmp
    vmp = oz * vmpm + fz * vmpp
    vpm = oz * vpmm + fz * vpmp
    vpp = oz * vppm + fz * vppp
    vm = oy * vmm + fy * vmp
    vp = oy * vpm + fy * vpp
    interp = ox * vm + fx * vp

    dx = vp - vm
    dy = ox * (vmp - vmm) + fx * (vpp - vpm)
    dz = (ox * (oy * (vmmp - vmmm) + fy * (vmpp - vmpm))
          + fx * (oy * (vpmp - vpmm) + fy * (vppp - vppm)))
    return interp, torch.stack([dx, dy, dz], dim=-1)


def _interp_bspline(grid: Grid, ixyz, f):
    nx, ny, nz = grid.counts
    ar4 = _index_tensor((-1, 0, 1, 2), ixyz.device)
    gx = (ixyz[..., 0:1] + ar4).clamp(0, nx - 1)       # [..., 4]
    gy = (ixyz[..., 1:2] + ar4).clamp(0, ny - 1)
    gz = (ixyz[..., 2:3] + ar4).clamp(0, nz - 1)
    flat_idx = (gx[..., :, None, None] * (ny * nz)
                + gy[..., None, :, None] * nz
                + gz[..., None, None, :])              # [..., 4, 4, 4]
    v = grid.vals.reshape(-1)[flat_idx]
    if grid_runtime_inv(grid):
        v = invpower_value(v, 1.0 / grid.inv_power)

    fx, fy, fz = f.unbind(-1)
    bx, by, bz = (basis.bspline_weights(c) for c in (fx, fy, fz))
    dbx, dby, dbz = (basis.bspline_derivs(c) for c in (fx, fy, fz))
    spec = "...i,...j,...k,...ijk->..."
    interp = torch.einsum(spec, bx, by, bz, v)
    dx = torch.einsum(spec, dbx, by, bz, v)
    dy = torch.einsum(spec, bx, dby, bz, v)
    dz = torch.einsum(spec, bx, by, dbz, v)
    return interp, torch.stack([dx, dy, dz], dim=-1)


def _hermite_tensor_eval(X, f, weights_fn, derivs_fn, ax, ay, az):
    """Tensor-product Hermite evaluation shared by tricubic/triquintic.

    Args:
      X:  [..., 8 corners, D] corner derivatives in cell-fractional units,
          or [..., G, 8, D] for G grids at the same fractions.
      f:  [..., 3] cell fractions.
      weights_fn / derivs_fn: 1-D basis family returning [..., M, 2]
          (M = number of derivative orders the family carries per axis).
      ax, ay, az: static length-D tuples of per-axis orders of X's slots.

    Returns (value [...], grad_s [..., 3]), with a trailing G axis before
    the 3 when X carries one.
    """
    fused = X.dim() == f.dim() + 2

    def w(fn, c, orders, sides):
        # [..., M, 2] -> [..., D, 8]: slot d at corner c takes the basis
        # function of order orders[d] on side sides[c]
        H = fn(f[..., c])
        idx = _index_tensor(tuple(2 * o + s for o in orders for s in sides),
                            H.device)
        sel = H.flatten(-2).index_select(-1, idx)
        sel = sel.reshape(sel.shape[:-1] + (len(orders), 8))
        return sel.unsqueeze(-3) if fused else sel

    wx = w(weights_fn, 0, ax, _CORNER_CX)
    wy = w(weights_fn, 1, ay, _CORNER_CY)
    wz = w(weights_fn, 2, az, _CORNER_CZ)
    gx = w(derivs_fn, 0, ax, _CORNER_CX)
    gy = w(derivs_fn, 1, ay, _CORNER_CY)
    gz = w(derivs_fn, 2, az, _CORNER_CZ)

    Xt = X.transpose(-1, -2)               # [..., D, 8]
    wyz = wy * wz * Xt
    value = (wx * wyz).sum((-1, -2))
    dvx = (gx * wyz).sum((-1, -2))
    dvy = (wx * gy * wz * Xt).sum((-1, -2))
    dvz = (wx * wy * gz * Xt).sum((-1, -2))
    return value, torch.stack([dvx, dvy, dvz], dim=-1)


def _interp_hermite(grid: Grid, ixyz, f):
    X = grid.derivs.reshape(-1, 27)[_flat_corner_indices(grid, ixyz)]
    if grid_runtime_inv(grid):
        X = apply_invpower(X, 1.0 / grid.inv_power)
    if grid.interp_method == InterpolationMethod.TRICUBIC:
        X = X.index_select(
            -1, _index_tensor(tuple(TRICUBIC_DERIV_MAP), X.device))
    return _hermite_tensor_eval(X, f,
                                *HERMITE_FAMILIES[int(grid.interp_method)])


_METHODS = {
    int(InterpolationMethod.TRILINEAR): _interp_trilinear,
    int(InterpolationMethod.BSPLINE): _interp_bspline,
    int(InterpolationMethod.TRICUBIC): _interp_hermite,
    int(InterpolationMethod.TRIQUINTIC): _interp_hermite,
}


def evaluate_grid(grid: Grid, positions, scaling_factors) -> GridEval:
    """Energy, forces and per-atom energies of atoms on one grid.

    Args:
      grid: the Grid (its method and inverse-power fields select the path).
      positions: [..., N, 3] absolute positions in nm.
      scaling_factors: [N] per-atom scaling factors.
    """
    if grid.interp_method in HERMITE_FAMILIES and grid.derivs is None:
        raise ValueError(
            f"interpolation method {grid.interp_method} requires "
            "precomputed derivatives (generate with "
            "compute_derivatives=True)")
    dtype = grid.vals.dtype
    positions = positions.to(dtype)
    scaling = torch.as_tensor(scaling_factors, dtype=dtype,
                              device=positions.device)
    pos, corner, inside, ixyz, f = locate(positions, grid.spacing,
                                          grid.origin, grid.counts)
    interp, grad_s = _METHODS[int(grid.interp_method)](grid, ixyz, f)
    return finish_single(interp, grad_s, grid_back_power(grid),
                         grid.spacing, scaling, pos, corner, inside,
                         grid.oob_k)


def grid_energy(grid: Grid, positions, scaling_factors):
    """Energy-only evaluation (differentiable; autograd gives -forces)."""
    return evaluate_grid(grid, positions, scaling_factors).energy
