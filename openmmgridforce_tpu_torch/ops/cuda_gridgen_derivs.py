"""Raw 27-derivative field sums: the hand-written CUDA kernel and its plain
twin.

Replaces the Pallas kernel ``openmmgridforce_tpu/ops/pallas_gridgen_derivs.py``
(``_derivs_kernel``). The kernel is ``csrc/gridgen_derivs.cu``; its source
note gives the bound and the design. Both return the uncapped, unscaled
mixed partials (canonical order of ``derivatives27``) of sum_a K_a / r^m
with r^2 clamped at 4e-4 nm^2; the tanh cap, the inverse-power chain rule
and the cell-fractional scaling follow in ``ops/gridgen.py``.

``gridgen_derivs`` is the wrapper: a CPU tensor goes to the plain twin, a
CUDA float32 tensor to the kernel, anything else raises. Its ``launches``
attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_gridgen import grid_point_positions
from .derivatives27 import N_DERIVS
from .radial import FIELD_POWERS, GRID_TYPE_CODES, cartesian_terms

R2_MIN_DERIVS = 4e-4    # nm^2: r >= 0.02 nm on the derivative path
_PAIR_BLOCK = 1 << 23   # points x atoms per chunk of the plain twin


def pair_derivative_terms(dx, dy, dz, K, grid_type: str):
    """The 27 derivative terms of K / r^m at displacement (dx, dy, dz), as
    the kernel forms them: one rsqrt of the clamped r^2, powers of 1/r by
    repeated multiplication. Returns a list of 27 tensors."""
    m, coefs = FIELD_POWERS[grid_type]
    r2 = (dx * dx + dy * dy + dz * dz).clamp_min(R2_MIN_DERIVS)
    inv_r = torch.rsqrt(r2)
    inv_rm = inv_r
    for _ in range(m - 1):
        inv_rm = inv_rm * inv_r
    base = K * inv_rm
    i2 = inv_r * inv_r
    i3 = i2 * inv_r
    i4 = i2 * i2
    i5 = i4 * inv_r
    i6 = i4 * i2
    rad = (base,
           coefs[1] * base * inv_r,
           coefs[2] * base * i2,
           coefs[3] * base * i3,
           coefs[4] * base * i4,
           coefs[5] * base * i5,
           coefs[6] * base * i6)
    return cartesian_terms(dx, dy, dz, inv_r, i2, i3, i4, i5, *rad)


def gridgen_derivs_plain(atoms, counts, spacing, origin, grid_type: str,
                         start: int = 0, stop: int | None = None,
                         pair_block: int = _PAIR_BLOCK):
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
        gx, gy, gz = grid_point_positions(counts, spacing, origin,
                                          idx).unbind(-1)
        terms = pair_derivative_terms(gx[:, None] - ax, gy[:, None] - ay,
                                      gz[:, None] - az, K, grid_type)
        for s, t in enumerate(terms):
            out[lo - start:hi - start, s] = t.sum(-1)
    return out


@functools.cache
def _library():
    """The kernel's shared library, built at first use, with its C entry
    points declared."""
    from .. import cuda_build

    lib = cuda_build.load("gridgen_derivs")
    fn = lib.gridgen_derivs_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_float] * 6
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.gridgen_derivs_error_string.argtypes = [ctypes.c_int]
    lib.gridgen_derivs_error_string.restype = ctypes.c_char_p
    return lib


def gridgen_derivs(atoms, counts, spacing, origin, grid_type: str):
    """Raw derivative sums [nx, ny, nz, 27] of the atoms [A, 4]
    (x, y, z, K).

    CPU tensors take the plain twin; CUDA float32 tensors take the kernel.
    """
    if atoms.ndim != 2 or atoms.shape[1] != 4:
        raise ValueError(f"atoms must be [A, 4], got {tuple(atoms.shape)}")
    if grid_type not in GRID_TYPE_CODES:
        raise ValueError(f"unknown grid type {grid_type!r}")
    counts = tuple(int(c) for c in counts)
    if min(counts) < 1 or atoms.shape[0] > 2**31 - 1:
        raise ValueError(f"bad grid counts {counts} or atom count")
    if atoms.device.type == "cpu":
        return gridgen_derivs_plain(atoms, counts, spacing, origin,
                                    grid_type).reshape(counts + (N_DERIVS,))
    if atoms.device.type != "cuda":
        raise ValueError(f"no gridgen kernel for device {atoms.device}")
    if atoms.dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA gridgen kernel takes float32, got {atoms.dtype} "
            "(float64 on CUDA: ROADMAP, Queue A)")
    if not atoms.is_contiguous() or atoms.data_ptr() % 16:
        raise ValueError("atoms must be contiguous and 16-byte aligned")
    lib = _library()
    out = torch.empty(counts + (N_DERIVS,), dtype=torch.float32,
                      device=atoms.device)
    stream = torch.cuda.current_stream(atoms.device).cuda_stream
    err = lib.gridgen_derivs_launch(
        atoms.data_ptr(), atoms.shape[0], out.data_ptr(), *counts,
        *(float(o) for o in origin), *(float(s) for s in spacing),
        GRID_TYPE_CODES[grid_type], atoms.device.index, stream)
    if err:
        raise RuntimeError("gridgen_derivs kernel launch failed: "
                           + lib.gridgen_derivs_error_string(err).decode())
    gridgen_derivs.launches += 1
    return out


gridgen_derivs.launches = 0
