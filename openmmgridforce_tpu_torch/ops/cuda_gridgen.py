"""Capped grid-field values: the hand-written CUDA kernel and its plain twin.

Replaces the Pallas kernel ``openmmgridforce_tpu/ops/pallas_gridgen.py``
(``_gen_kernel``). The kernel is ``csrc/gridgen_values.cu``; its source
note gives the bound and the design.

``gridgen_values`` is the wrapper: a CPU tensor goes to the plain twin, a
CUDA float32 or float64 tensor to the kernel's instantiation of that type,
anything else raises. Its ``launches`` attribute counts kernel launches.

``index_offset`` (i0, j0, k0) places the points of a call in a larger
grid: point (i, j, k) of the result lies at origin + (i0 + i, j0 + j,
k0 + k) * spacing, so a slab of a grid is computed from the global index,
exactly as the whole grid computes it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .chain_rules import tanh_cap_value
from .radial import GRID_TYPE_CODES

_PAIR_BLOCK = 1 << 24   # points x atoms per chunk of the plain twin


def grid_point_positions(counts, spacing, origin, flat_index,
                         index_offset=(0, 0, 0)):
    """Positions [..., 3] of grid points given flat (z-fastest) indices
    into ``counts``, formed as the kernel forms them: origin + (index +
    index_offset) * spacing in the dtype of ``spacing``."""
    _, ny, nz = counts
    nyz = ny * nz
    i = flat_index // nyz
    rem = flat_index - i * nyz
    j = rem // nz
    k = rem - j * nz
    ijk = torch.stack([i, j, k], dim=-1)
    if any(index_offset):
        ijk = ijk + torch.as_tensor(index_offset, dtype=ijk.dtype,
                                    device=ijk.device)
    return origin + ijk * spacing


def gridgen_values_plain(atoms, counts, spacing, origin, grid_type: str,
                         grid_cap: float, pair_block: int = _PAIR_BLOCK,
                         index_offset=(0, 0, 0)):
    """Plain PyTorch version of the kernel, chunked over points.

    ``atoms``: [A, 4] rows (x, y, z, K). Returns [nx, ny, nz] in the dtype
    of ``atoms``, on its device.
    """
    code = GRID_TYPE_CODES[grid_type]
    counts = tuple(int(c) for c in counts)
    total = counts[0] * counts[1] * counts[2]
    dtype, device = atoms.dtype, atoms.device
    spacing = torch.tensor(spacing, dtype=dtype, device=device)
    origin = torch.tensor(origin, dtype=dtype, device=device)
    out = torch.empty(total, dtype=dtype, device=device)
    ax, ay, az, K = (atoms[:, c] for c in range(4))
    chunk = max(1, pair_block // max(1, atoms.shape[0]))
    for start in range(0, total, chunk):
        stop = min(start + chunk, total)
        idx = torch.arange(start, stop, dtype=torch.int64, device=device)
        gx, gy, gz = grid_point_positions(counts, spacing, origin, idx,
                                          index_offset).unbind(-1)
        dx = gx[:, None] - ax
        dy = gy[:, None] - ay
        dz = gz[:, None] - az
        r2 = (dx * dx + dy * dy + dz * dz).clamp_min(1e-12)
        inv_r = torch.rsqrt(r2)
        if code == 0:       # charge: K / r
            contrib = K * inv_r
        elif code == 1:     # ljr: K / r^12
            inv_r2 = inv_r * inv_r
            inv_r4 = inv_r2 * inv_r2
            contrib = K * (inv_r4 * inv_r4 * inv_r4)
        else:               # lja: K / r^6
            inv_r2 = inv_r * inv_r
            contrib = K * (inv_r2 * inv_r2 * inv_r2)
        out[start:stop] = tanh_cap_value(contrib.sum(-1), grid_cap)
    return out.reshape(counts)


def _declare(lib):
    """Declares the C entry points of the kernel's shared library."""
    for name, real in (("gridgen_values_launch", ctypes.c_float),
                       ("gridgen_values_launch_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 6 + [real] * 7
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    shape = lib.gridgen_values_launch_shape
    shape.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    shape.restype = ctypes.c_int
    probe = lib.gridgen_values_reciprocal_probe
    probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    lib.gridgen_values_error_string.argtypes = [ctypes.c_int]
    lib.gridgen_values_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library():
    """The kernel's shared library, built at first use."""
    from .. import cuda_build

    return _declare(cuda_build.load("gridgen_values"))


def _launch_shape(lib, name: str, counts, grid_type: str, device,
                  dtype) -> dict:
    blocks = ctypes.c_longlong()
    threads, per_sm = ctypes.c_int(), ctypes.c_int()
    err = getattr(lib, name + "_launch_shape")(
        *(int(c) for c in counts), GRID_TYPE_CODES[grid_type],
        int(dtype == torch.float64), int(device), ctypes.byref(blocks),
        ctypes.byref(threads), ctypes.byref(per_sm))
    if err:
        raise RuntimeError(
            f"{name}_launch_shape failed: "
            + getattr(lib, name + "_error_string")(err).decode())
    return {"blocks": blocks.value, "threads": threads.value,
            "blocks_per_sm": per_sm.value}


def launch_shape(counts, grid_type: str, device=0,
                 dtype=torch.float32) -> dict:
    """How the kernel's ``dtype`` instantiation is launched for a grid of
    ``counts`` points: blocks, threads per block, and the blocks one SM
    holds at a time (asked of the CUDA runtime). Builds the library at
    first use; needs the card."""
    return _launch_shape(_library(), "gridgen_values", counts, grid_type,
                         device, dtype)


def reciprocal_probe(x):
    """The float64 kernel's reciprocals alone, on CUDA float64 ``x`` [n]
    (r^2 values): [n, 4] of the MUFU seeds of 1/sqrt(x) and 1/x and the
    values its Newton steps finish from them. A diagnostic of the card's
    seeds, which the CPU has no copy of: raises for other tensors."""
    if x.device.type != "cuda" or x.dtype != torch.float64 or x.ndim != 1:
        raise ValueError("the reciprocal probe takes a CUDA float64 vector")
    x = x.contiguous()
    out = torch.empty((x.shape[0], 4), dtype=x.dtype, device=x.device)
    lib = _library()
    err = lib.gridgen_values_reciprocal_probe(
        x.data_ptr(), x.shape[0], out.data_ptr(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("reciprocal probe launch failed: "
                           + lib.gridgen_values_error_string(err).decode())
    return out


def _check_cuda_atoms(atoms, counts):
    """Raises on what the kernels do not take; returns the launch entry
    point's suffix for the atoms' dtype."""
    if atoms.device.type != "cuda":
        raise ValueError(f"no gridgen kernel for device {atoms.device}")
    if atoms.dtype not in (torch.float32, torch.float64):
        raise ValueError(
            f"the CUDA gridgen kernels take float32 or float64, got "
            f"{atoms.dtype}")
    if not atoms.is_contiguous() or atoms.data_ptr() % 16:
        raise ValueError("atoms must be contiguous and 16-byte aligned")
    if min(counts) < 1 or atoms.shape[0] > 2**31 - 1:
        raise ValueError(f"bad grid counts {counts} or atom count")
    return "_f64" if atoms.dtype == torch.float64 else ""


def gridgen_values(atoms, counts, spacing, origin, grid_type: str,
                   grid_cap: float, index_offset=(0, 0, 0)):
    """Capped field values [nx, ny, nz] of the atoms [A, 4] (x, y, z, K),
    at points ``index_offset`` + (i, j, k) of the grid that ``origin`` and
    ``spacing`` describe.

    CPU tensors take the plain twin; CUDA float32 and float64 tensors take
    the kernel's instantiation of their type.
    """
    if atoms.ndim != 2 or atoms.shape[1] != 4:
        raise ValueError(f"atoms must be [A, 4], got {tuple(atoms.shape)}")
    if grid_type not in GRID_TYPE_CODES:
        raise ValueError(f"unknown grid type {grid_type!r}")
    index_offset = tuple(int(o) for o in index_offset)
    if atoms.device.type == "cpu":
        return gridgen_values_plain(atoms, counts, spacing, origin,
                                    grid_type, grid_cap,
                                    index_offset=index_offset)
    counts = tuple(int(c) for c in counts)
    suffix = _check_cuda_atoms(atoms, counts)
    lib = _library()
    out = torch.empty(counts, dtype=atoms.dtype, device=atoms.device)
    stream = torch.cuda.current_stream(atoms.device).cuda_stream
    err = getattr(lib, "gridgen_values_launch" + suffix)(
        atoms.data_ptr(), atoms.shape[0], out.data_ptr(), *counts,
        *index_offset, *(float(o) for o in origin),
        *(float(s) for s in spacing), float(grid_cap),
        GRID_TYPE_CODES[grid_type], atoms.device.index, stream)
    if err:
        raise RuntimeError("gridgen_values kernel launch failed: "
                           + lib.gridgen_values_error_string(err).decode())
    gridgen_values.launches += 1
    return out


gridgen_values.launches = 0
