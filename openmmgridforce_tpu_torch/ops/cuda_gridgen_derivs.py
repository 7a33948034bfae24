"""Raw 27-derivative field sums: the hand-written CUDA kernel and its plain
twin.

Replaces the Pallas kernel ``openmmgridforce_tpu/ops/pallas_gridgen_derivs.py``
(``_derivs_kernel``). The kernel is ``csrc/gridgen_derivs.cu``; its source
note gives the bound and the design. Both return the uncapped, unscaled
mixed partials (canonical order of ``derivatives27``) of sum_a K_a / r^m
with r^2 clamped at 4e-4 nm^2; the tanh cap, the inverse-power chain rule
and the cell-fractional scaling follow in ``ops/gridgen.py``.

``gridgen_derivs`` is the wrapper: a CPU tensor goes to the plain twin, a
CUDA float32 or float64 tensor to the kernel's instantiation of that type,
anything else raises. Its ``launches`` attribute counts kernel launches.
``index_offset`` places the points of a call in a larger grid, as for
``cuda_gridgen.gridgen_values``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_gridgen import (_check_cuda_atoms, _launch_shape,
                           grid_point_positions)
from .derivatives27 import N_DERIVS
from .radial import FIELD_POWERS, GRID_TYPE_CODES

R2_MIN_DERIVS = 4e-4    # nm^2: r >= 0.02 nm on the derivative path
_PAIR_BLOCK = 1 << 23   # points x atoms per chunk of the plain twin


def folded_constants(grid_type: str):
    """(m, (t_1, ..., t_6)) of the grid type's field K / r^m. Every radial
    combination of the Cartesian cascade (``radial.cartesian_terms``) is
    one of these constants times K / r^(m+n) for a pure power law:
    A_n = t_n P_n, B_n = t_(n-1) P_n, C_n = t_(n-2) P_n, D_6 = t_3 P_6 and
    dU = t_1 P_1, with t_n = (-1)^n m (m+2) ... (m+2n-2)."""
    m, _ = FIELD_POWERS[grid_type]
    t, out = 1, []
    for n in range(1, 7):
        t *= -(m + 2 * n - 2)
        out.append(float(t))
    return m, tuple(out)


def pair_derivative_terms(dx, dy, dz, K, grid_type: str):
    """The 27 derivative terms of K / r^m at displacement (dx, dy, dz), in
    the folded formulation the kernel computes: one rsqrt of the clamped
    r^2, 1/r^m by squarings, P_n = K / r^(m+n) by a chain of multiplies by
    1/r, every cascade combination one constant times P_n, and each product
    of direction cosines formed once. (The kernel carries the constants
    inside its FMAs; here each costs a multiply.) Returns a list of 27
    tensors."""
    m, (t1, t2, t3, t4, t5, t6) = folded_constants(grid_type)
    r2 = (dx * dx + dy * dy + dz * dz).clamp_min(R2_MIN_DERIVS)
    inv_r = torch.rsqrt(r2)
    inv_rm = inv_r
    if m > 1:
        i2 = inv_r * inv_r
        i3 = i2 * inv_r
        inv_rm = i3 * i3
    if m == 12:
        inv_rm = inv_rm * inv_rm
    P0 = K * inv_rm
    P1 = P0 * inv_r
    P2 = P1 * inv_r
    P3 = P2 * inv_r
    P4 = P3 * inv_r
    P5 = P4 * inv_r
    P6 = P5 * inv_r
    dU, dUr, A2 = t1 * P1, t1 * P2, t2 * P2
    A3, B3 = t3 * P3, t2 * P3
    A4, B4, C4 = t4 * P4, t3 * P4, t2 * P4
    A5, B5, C5 = t5 * P5, t4 * P5, t3 * P5
    A6, B6, C6, D6 = t6 * P6, t5 * P6, t4 * P6, t3 * P6
    nx, ny, nz = dx * inv_r, dy * inv_r, dz * inv_r
    nx2, ny2, nz2 = nx * nx, ny * ny, nz * nz
    xy, xz, yz = nx * ny, nx * nz, ny * nz
    Gx, Gy, Gz = A3 * nx2 + B3, A3 * ny2 + B3, A3 * nz2 + B3
    qxy, qxz, qyz = nx2 * ny2, nx2 * nz2, ny2 * nz2
    sxy, sxz, syz = nx2 + ny2, nx2 + nz2, ny2 + nz2
    Hx, Hy, Hz = A4 * nx2 + B4, A4 * ny2 + B4, A4 * nz2 + B4
    return [
        P0, dU * nx, dU * ny, dU * nz,
        A2 * nx2 + dUr, A2 * xy, A2 * xz, A2 * ny2 + dUr, A2 * yz,
        A2 * nz2 + dUr,
        Gx * ny, Gx * nz, Gy * nx, A3 * (xy * nz), Gy * nz, Gz * nx,
        Gz * ny,
        A4 * qxy + (B4 * sxy + C4), A4 * qxz + (B4 * sxz + C4),
        A4 * qyz + (B4 * syz + C4),
        Hx * yz, Hy * xz, Hz * xy,
        (A5 * qxy + (B5 * sxy + C5)) * nz,
        (A5 * qxz + (B5 * sxz + C5)) * ny,
        (A5 * qyz + (B5 * syz + C5)) * nx,
        A6 * (qxy * nz2) + (B6 * (qxy + qxz + qyz)
                            + (C6 * (sxy + nz2) + D6)),
    ]


def gridgen_derivs_plain(atoms, counts, spacing, origin, grid_type: str,
                         start: int = 0, stop: int | None = None,
                         pair_block: int = _PAIR_BLOCK,
                         index_offset=(0, 0, 0)):
    """Plain PyTorch version of the kernel, chunked over points.

    ``atoms``: [A, 4] rows (x, y, z, K). Computes the points with flat
    (z-fastest) indices in [start, stop), the whole grid by default, and
    returns [stop - start, 27] in the dtype of ``atoms``, on its device.
    """
    if grid_type not in GRID_TYPE_CODES:
        raise ValueError(f"unknown grid type {grid_type!r}")
    counts = tuple(int(c) for c in counts)
    total = counts[0] * counts[1] * counts[2]
    stop = total if stop is None else int(stop)
    if not 0 <= start <= stop <= total:
        raise ValueError(f"bad point range [{start}, {stop}) of {total}")
    dtype, device = atoms.dtype, atoms.device
    spacing = torch.tensor(spacing, dtype=dtype, device=device)
    origin = torch.tensor(origin, dtype=dtype, device=device)
    out = torch.empty(stop - start, N_DERIVS, dtype=dtype, device=device)
    ax, ay, az, K = (atoms[:, c] for c in range(4))
    chunk = max(1, pair_block // max(1, atoms.shape[0]))
    for lo in range(start, stop, chunk):
        hi = min(lo + chunk, stop)
        idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
        gx, gy, gz = grid_point_positions(counts, spacing, origin, idx,
                                          index_offset).unbind(-1)
        terms = pair_derivative_terms(gx[:, None] - ax, gy[:, None] - ay,
                                      gz[:, None] - az, K, grid_type)
        for s, t in enumerate(terms):
            out[lo - start:hi - start, s] = t.sum(-1)
    return out


def _declare(lib):
    """Declares the C entry points of the kernel's shared library."""
    for name, real in (("gridgen_derivs_launch", ctypes.c_float),
                       ("gridgen_derivs_launch_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 6 + [real] * 6
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    shape = lib.gridgen_derivs_launch_shape
    shape.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    shape.restype = ctypes.c_int
    lib.gridgen_derivs_error_string.argtypes = [ctypes.c_int]
    lib.gridgen_derivs_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library():
    """The kernel's shared library, built at first use."""
    from .. import cuda_build

    return _declare(cuda_build.load("gridgen_derivs"))


def launch_shape(counts, grid_type: str, device=0,
                 dtype=torch.float32) -> dict:
    """How the kernel's ``dtype`` instantiation is launched for a grid of
    ``counts`` points: blocks, threads per block, and the blocks one SM
    holds at a time (asked of the CUDA runtime). Builds the library at
    first use; needs the card."""
    return _launch_shape(_library(), "gridgen_derivs", counts, grid_type,
                         device, dtype)


def gridgen_derivs(atoms, counts, spacing, origin, grid_type: str,
                   index_offset=(0, 0, 0)):
    """Raw derivative sums [nx, ny, nz, 27] of the atoms [A, 4]
    (x, y, z, K), at points ``index_offset`` + (i, j, k) of the grid that
    ``origin`` and ``spacing`` describe.

    CPU tensors take the plain twin; CUDA float32 and float64 tensors take
    the kernel's instantiation of their type.
    """
    if atoms.ndim != 2 or atoms.shape[1] != 4:
        raise ValueError(f"atoms must be [A, 4], got {tuple(atoms.shape)}")
    if grid_type not in GRID_TYPE_CODES:
        raise ValueError(f"unknown grid type {grid_type!r}")
    counts = tuple(int(c) for c in counts)
    if min(counts) < 1 or atoms.shape[0] > 2**31 - 1:
        raise ValueError(f"bad grid counts {counts} or atom count")
    index_offset = tuple(int(o) for o in index_offset)
    if atoms.device.type == "cpu":
        return gridgen_derivs_plain(
            atoms, counts, spacing, origin, grid_type,
            index_offset=index_offset).reshape(counts + (N_DERIVS,))
    suffix = _check_cuda_atoms(atoms, counts)
    lib = _library()
    out = torch.empty(counts + (N_DERIVS,), dtype=atoms.dtype,
                      device=atoms.device)
    stream = torch.cuda.current_stream(atoms.device).cuda_stream
    err = getattr(lib, "gridgen_derivs_launch" + suffix)(
        atoms.data_ptr(), atoms.shape[0], out.data_ptr(), *counts,
        *index_offset, *(float(o) for o in origin),
        *(float(s) for s in spacing), GRID_TYPE_CODES[grid_type],
        atoms.device.index, stream)
    if err:
        raise RuntimeError("gridgen_derivs kernel launch failed: "
                           + lib.gridgen_derivs_error_string(err).decode())
    gridgen_derivs.launches += 1
    return out


gridgen_derivs.launches = 0
