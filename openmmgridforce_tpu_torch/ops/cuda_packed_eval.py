"""Fused evaluation of a polynomial pack: the hand-written CUDA kernel (K3)
and its plain twin.

Replaces the JAX package's ``openmmgridforce_tpu/ops/packed.py``
(``evaluate_multi``), which is XLA einsums there, not a Pallas kernel.
The kernel is ``csrc/packed_eval.cu``; its source note gives the bound and
the design.

``packed_eval`` is the wrapper: a CPU tensor goes to the plain twin, a
CUDA float32 or float64 tensor to the kernel, anything else raises. Its
``launches`` attribute counts kernel launches. On the card the result is
differentiable in the positions (``PackedEval``: each atom's energy
depends on its own position alone, so the gradient is -forces).

``packed_eval_plain`` is the plain version: ``ops/packed.py``'s row
gather, tensor-product polynomials (``_tensor_poly``) and tail of the
fused evaluators (``_finish_multi``), as ATen ops. It is the CPU route
and the oracle of the tests and of ``chip_smoke.py``.

A table split over x-cells (``parallel/sharded_grid.py``) holds the rows
of the cells [x_lo, x_lo + x_count) along x: both versions count only the
atoms whose cell lies there, and the restraint only where ``restrain``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch.autograd.function import once_differentiable

from .interpolate import const_tensor

# the degrees d (per-axis polynomial degree + 1) the kernel instantiates
DEGREES = (2, 4, 6)
POLY_BASES = ("monomial", "chebyshev")


# ----------------------------------------------------------------------
# The plain version
# ----------------------------------------------------------------------

def _x_window(table, x_lo, x_count):
    ncx = table.counts[0] - 1
    return int(x_lo), ncx if x_count is None else int(x_count)


def packed_eval_plain(table, positions, scaling, x_lo: int = 0,
                      x_count: int | None = None, restrain: bool = True):
    """Plain PyTorch version of the kernel: per-atom energies [..., N] and
    forces [..., N, 3] of ``positions`` [..., N, 3] on the fused table
    (a ``MultiPackedGrid``, or a sharded table's polynomial rows) with
    ``scaling`` [G, N] (or [1, N], shared by every grid), in the table's
    dtype and on its device. The table holds the cells [x_lo, x_lo +
    x_count) along x (default: all)."""
    # the evaluators' shared steps (ops/packed.py imports this module)
    from .packed import _finish_multi, _gather_window, _tensor_poly

    x_lo, x_count = _x_window(table, x_lo, x_count)
    scaling = scaling.reshape(-1, positions.shape[-2])
    pos, corner, inside, owned, f, rows = _gather_window(
        table, positions, x_lo, x_count)
    d = table.degree
    R = rows.reshape(rows.shape[:-1] + (table.n_grids, d, d, d))
    interp, grad_s = _tensor_poly(R, f, d, table.poly_basis)
    res = _finish_multi(interp, grad_s, table.back_powers, table.spacing,
                        scaling, pos, corner, inside, table.oob_k,
                        owned=owned, restrain=restrain)
    return res.per_atom_energy, res.forces


# ----------------------------------------------------------------------
# The kernel
# ----------------------------------------------------------------------

LANES = 4                 # threads an atom
TILE_ATOMS = 16           # atoms a block stages, at most (32: 128 threads)
MAX_SHARED = 232_448      # bytes of shared memory a block may use (H100)
BARRIER_BYTES = 16        # the kernel's static mbarrier
MAX_ATOMS = 2 ** 31 - 1   # atoms a call (the kernel indexes in 32 bits)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the kernel tiles a launch: ``tile_atoms`` atoms a block (4
    threads each), each atom's row of ``row_bytes`` staged in a slot of
    ``slot_bytes`` of shared memory; ``shared_bytes`` is a block's whole
    use of it (slots and barrier)."""

    tile_atoms: int
    row_bytes: int
    slot_bytes: int

    @property
    def threads(self) -> int:
        return LANES * self.tile_atoms

    @property
    def shared_bytes(self) -> int:
        return self.tile_atoms * self.slot_bytes + BARRIER_BYTES

    def blocks(self, n_total: int) -> int:
        return -(-int(n_total) // self.tile_atoms)


def launch_plan(degree: int, n_grids: int, dtype) -> LaunchPlan:
    """The kernel's tile for rows of ``n_grids`` grids of ``degree`` in
    ``dtype``: TILE_ATOMS atoms a block, fewer where their slots would
    pass a block's shared memory (whole warps of 8 atoms where 8 fit). A
    slot is the row's bytes, 64 more where the row is a multiple of 128
    (so that the two atoms a quarter-warp reads start on different
    banks). Raises where one row does not fit."""
    row = int(n_grids) * int(degree) ** 3 * torch.finfo(dtype).bits // 8
    slot = row + 64 if row % 128 == 0 else row
    fit = (MAX_SHARED - BARRIER_BYTES) // slot
    if fit < 1:
        raise ValueError(f"the packed_eval kernel stages a row of {row} "
                         f"bytes ({n_grids} grids of degree {degree}, "
                         f"{dtype}) in shared memory; a block has "
                         f"{MAX_SHARED}")
    tile = min(TILE_ATOMS, fit)
    if tile >= 8:
        tile -= tile % 8
    return LaunchPlan(tile_atoms=tile, row_bytes=row, slot_bytes=slot)


def atom_order(n_total: int, n_atoms: int) -> torch.Tensor:
    """The atom each launch slot evaluates in the kernel's atom-major
    order (its ``kAtomMajor`` switch, which ``kernel_variants.py`` times;
    the shipped kernel takes the [B, N] order, slot j atom j): slot j is
    replica j % B of ligand atom j // B (B = n_total / n_atoms), so the
    replicas of one ligand atom, which share cells, run side by side.
    Atoms are numbered in the [B, N] order of the positions."""
    replicas = n_total // n_atoms
    j = torch.arange(n_total)
    return (j % replicas) * n_atoms + j // replicas


def _declare(lib):
    """Declares the C entry points of the kernel's shared library."""
    fn = lib.packed_eval_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 12
                   + [ctypes.c_double] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.packed_eval_error_string.argtypes = [ctypes.c_int]
    lib.packed_eval_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library():
    """The kernel's shared library, built at first use."""
    from .. import cuda_build

    return _declare(cuda_build.load("packed_eval"))


def _check_cuda(table, positions, scaling, x_lo, x_count) -> LaunchPlan:
    """Raises on what the kernel does not take; else its launch plan."""
    coeffs, device = table.coeffs, positions.device
    if coeffs.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the packed_eval kernel takes float32 or float64, "
                         f"got {coeffs.dtype}")
    if table.degree not in DEGREES:
        raise ValueError(f"the packed_eval kernel takes degrees {DEGREES}, "
                         f"got {table.degree}")
    if table.poly_basis not in POLY_BASES:
        raise ValueError(f"unknown poly_basis {table.poly_basis!r}")
    G = table.n_grids
    width = G * table.degree ** 3
    if coeffs.dim() != 2 or coeffs.shape[1] != width:
        raise ValueError(f"coeffs must be [cells, {width}], got "
                         f"{tuple(coeffs.shape)}")
    if not coeffs.is_contiguous() or coeffs.data_ptr() % 16:
        raise ValueError("coeffs must be contiguous and 16-byte aligned")
    if min(table.counts) < 2:
        raise ValueError(f"a pack needs 2 points an axis, got "
                         f"{table.counts}")
    if len(table.back_powers) != G:
        raise ValueError(f"{len(table.back_powers)} back powers for {G} "
                         f"grids")
    plan = launch_plan(table.degree, G, coeffs.dtype)
    _, ncy, ncz = table.cell_counts
    if x_lo < 0 or x_count * ncy * ncz > coeffs.shape[0]:
        raise ValueError(f"the table's {coeffs.shape[0]} rows do not hold "
                         f"{x_count} x-cells")
    for name, t in (("coeffs", coeffs), ("positions", positions),
                    ("scaling", scaling), ("spacing", table.spacing),
                    ("origin", table.origin)):
        if t.device != device or t.dtype != coeffs.dtype:
            raise ValueError(f"{name} must be {coeffs.dtype} on {device}, "
                             f"got {t.dtype} on {t.device}")
    if device.type != "cuda":
        raise ValueError(f"no packed_eval kernel for device {device}")
    return plan


def _launch(table, positions, scaling, x_lo, x_count, restrain):
    """The kernel on CUDA tensors: (energies [..., N], forces [..., N,
    3])."""
    plan = _check_cuda(table, positions, scaling, x_lo, x_count)
    if positions.dim() < 2 or positions.shape[-1] != 3:
        raise ValueError(f"positions must be [..., N, 3], got "
                         f"{tuple(positions.shape)}")
    G, N = table.n_grids, positions.shape[-2]
    scaling = scaling.reshape(-1, N)
    if scaling.shape[0] not in (1, G):
        raise ValueError(f"scaling must be [{G}, {N}] or [1, {N}], got "
                         f"{tuple(scaling.shape)}")
    # a row shared by every grid is read with a grid stride of 0, not
    # copied for each grid
    scaling = scaling.contiguous()
    x = positions.contiguous()
    device, dtype = x.device, x.dtype
    energy = torch.empty(x.shape[:-1], dtype=dtype, device=device)
    forces = torch.empty(x.shape, dtype=dtype, device=device)
    total = energy.numel()
    if total == 0:
        return energy, forces
    if total > MAX_ATOMS:
        raise ValueError(f"the packed_eval kernel takes at most {MAX_ATOMS} "
                         f"atoms a call, got {total}")
    back = const_tensor(tuple(table.back_powers), dtype, device)
    lib = _library()
    err = lib.packed_eval_launch(
        table.coeffs.data_ptr(), x.data_ptr(), scaling.data_ptr(),
        table.spacing.data_ptr(), table.origin.data_ptr(), back.data_ptr(),
        energy.data_ptr(), forces.data_ptr(), total, N,
        N if scaling.shape[0] > 1 else 0, G, table.degree,
        int(table.poly_basis == "chebyshev"), int(dtype == torch.float64),
        *table.counts, x_lo, x_count, int(bool(restrain)),
        float(table.oob_k), plan.tile_atoms, plan.slot_bytes, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError("packed_eval kernel launch failed: "
                           + lib.packed_eval_error_string(err).decode())
    packed_eval.launches += 1
    return energy, forces


class PackedEval(torch.autograd.Function):
    """``packed_eval`` differentiable in the positions: an atom's energy
    depends on its own position alone, so d(sum w E)/dx = -w * forces."""

    @staticmethod
    def forward(ctx, positions, table, scaling, x_lo, x_count, restrain):
        # no grad here: the kernel on the card, the twin on the host
        energy, forces = packed_eval(table, positions, scaling, x_lo,
                                     x_count, restrain)
        ctx.save_for_backward(forces)
        ctx.mark_non_differentiable(forces)
        return energy, forces

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_energy, grad_forces):
        (forces,) = ctx.saved_tensors
        return -forces * grad_energy[..., None], None, None, None, None, None


def packed_eval(table, positions, scaling, x_lo: int = 0,
                x_count: int | None = None, restrain: bool = True):
    """Per-atom energies [..., N] and forces [..., N, 3] of ``positions``
    [..., N, 3] on a fused polynomial table (see ``packed_eval_plain``).

    CPU tensors take the plain version; CUDA float32 and float64 tensors
    the kernel, differentiable in the positions only (scalings or
    coefficients that require grad raise there)."""
    x_lo, x_count = _x_window(table, x_lo, x_count)
    if positions.device.type == "cpu":
        return packed_eval_plain(table, positions, scaling, x_lo, x_count,
                                 restrain)
    if torch.is_grad_enabled() and (scaling.requires_grad
                                    or table.coeffs.requires_grad):
        raise ValueError("the packed_eval kernel differentiates the "
                         "positions only")
    if torch.is_grad_enabled() and positions.requires_grad:
        return PackedEval.apply(positions, table, scaling, x_lo, x_count,
                                restrain)
    return _launch(table, positions, scaling, x_lo, x_count, restrain)


packed_eval.launches = 0
