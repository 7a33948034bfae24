"""The constraint solver on the card: SHAKE and RATTLE, each one launch of
a hand-written CUDA kernel a call, beside the plain twin in
``mm/constraints.py``.

The kernel is ``csrc/constraints.cu`` (library ``constraints``, built and
loaded at the first constrained call, so unconstrained runs never build
it). It replaces no Pallas kernel: it is the JAX package's
``lax.while_loop`` sweeps (``openmmgridforce_tpu/mm/constraints.py``). It
is latency bound, a chain of dependent sweeps over negligible bytes and
FLOPs, and its design keeps the chain on chip: one block a replica runs
every sweep of that replica, to the replica's own stop, out of shared
memory. The source note gives the design.

``constraint_shake(cs, x_ref, x_new, ...)`` and
``constraint_rattle(cs, x, v, ...)`` take CUDA float32 or float64 tensors
[..., N, 3] of the constraint set's dtype and device, and raise on
anything else; ``mm/constraints.py::apply_shake`` / ``apply_rattle`` route
CUDA tensors here and CPU tensors to the twin. Each wrapper's ``launches``
counts its kernel's launches.

The kernel reads per-set tables, built on the host once and cached by the
identity of the constraint set's tensors (``ops/scatter.py::cached``), so
that a call inside a recording issues no synchronisation and one kernel
node: the pairs, d0^2, the inverse-mass sums, and each atom's rows of the
twin's row sum (``ops/scatter.py::row_table``'s order, weights -1/m_i and
+1/m_j).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .scatter import cached, row_table

WARP = 32
MAX_THREADS = 256         # threads a block, at most (csrc/constraints.cu)
MAX_SHARED = 232_448      # bytes of shared memory a block may use (H100)


class ConstraintTables(NamedTuple):
    """A constraint set's tables on its device: atom n receives the rows
    ``row_start[n]:row_start[n + 1]``, row k the update of constraint
    ``row_pair[k]`` times ``row_weight[k]`` (int32 indices, the rest in
    the set's dtype)."""

    pairs: torch.Tensor        # [C, 2]
    length_sq: torch.Tensor    # [C] d0^2
    two_im: torch.Tensor       # [C] 2 (1/m_i + 1/m_j)
    im_sum: torch.Tensor       # [C] 1/m_i + 1/m_j
    row_start: torch.Tensor    # [N + 1]
    row_pair: torch.Tensor     # [2C]
    row_weight: torch.Tensor   # [2C]


def constraint_tables(cs) -> ConstraintTables:
    """The kernel's tables of ConstraintSet ``cs``, built once per set's
    tensors (the twin's ``mm/constraints.py::_pair_tensors``, laid out by
    atom)."""
    def build():
        n_atoms = cs.inv_mass.shape[0]
        idx = cs.idx
        if idx.dim() != 2 or idx.shape[1] != 2:
            raise ValueError(f"constraint pairs must be [C, 2], got "
                             f"{tuple(idx.shape)}")
        host = idx.cpu().numpy()
        if host.size and (host.min() < 0 or host.max() >= n_atoms):
            raise ValueError(f"a constraint names an atom outside "
                             f"[0, {n_atoms})")
        n_pairs = len(host)
        i, j = idx[:, 0], idx[:, 1]
        im_i, im_j = cs.inv_mass[i], cs.inv_mass[j]
        table = row_table(torch.cat([i, j]), n_atoms)
        live = table < 2 * n_pairs
        rows = torch.as_tensor(table[live], device=idx.device)
        dev = idx.device
        return ConstraintTables(
            pairs=torch.as_tensor(host, dtype=torch.int32, device=dev),
            length_sq=cs.length * cs.length,
            two_im=2.0 * (im_i + im_j),
            im_sum=im_i + im_j,
            row_start=torch.as_tensor(
                np.concatenate([[0], np.cumsum(live.sum(1))]),
                dtype=torch.int32, device=dev),
            row_pair=(rows % n_pairs).to(torch.int32),
            row_weight=torch.cat([-im_i, im_j])[rows])

    return cached((cs.idx, cs.length, cs.inv_mass), "constraints", build)


def launch_plan(n_atoms: int, n_pairs: int, dtype):
    """(threads, shared bytes) of a block: a warp or more, enough for one
    thread a constraint and one an atom up to MAX_THREADS; the replica's
    state, the pairs' directions, updates and scalars and the row table in
    shared memory. Raises where they do not fit a block."""
    item = torch.finfo(dtype).bits // 8
    shared = (3 * n_atoms + 10 * n_pairs) * item + (4 * n_pairs + n_atoms
                                                     + 1) * 4
    if shared > MAX_SHARED:
        raise ValueError(f"the constraint kernel stages {shared} bytes a "
                         f"replica ({n_atoms} atoms, {n_pairs} constraints) "
                         f"in shared memory; a block has {MAX_SHARED}")
    threads = min(MAX_THREADS,
                  -(-max(n_atoms, n_pairs, 1) // WARP) * WARP)
    return threads, shared


def _declare(lib):
    """Declares the C entry points of the kernel's shared library."""
    args = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
            + [ctypes.c_int] * 2 + [ctypes.c_double] * 2 + [ctypes.c_int]
            + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
    for fn in (lib.constraint_shake_launch, lib.constraint_rattle_launch):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.constraints_error_string.argtypes = [ctypes.c_int]
    lib.constraints_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library():
    """The kernel's shared library, built at first use."""
    from .. import cuda_build

    return _declare(cuda_build.load("constraints"))


def _launch(kind, cs, ref, state, max_iter, threshold, omega, stats):
    """One launch of the ``kind`` ("shake" or "rattle") kernel: (state
    corrected, sweeps [...]) for ``ref`` and ``state`` [..., N, 3].
    ``stats``: SweepStats' (sums, maxes, scratch) buffers on the device,
    or None (not counted)."""
    dtype, device = state.dtype, state.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the constraint kernel takes float32 or float64, "
                         f"got {dtype}")
    if device.type != "cuda":
        raise ValueError(f"no constraint kernel for device {device}")
    n_atoms = cs.inv_mass.shape[0]
    if state.dim() < 2 or state.shape[-2:] != (n_atoms, 3) \
            or ref.shape != state.shape:
        raise ValueError(f"the constraint kernel takes two [..., {n_atoms}, "
                         f"3] tensors, got {tuple(ref.shape)} and "
                         f"{tuple(state.shape)}")
    for name, t in (("reference", ref), ("constraint lengths", cs.length),
                    ("inverse masses", cs.inv_mass)):
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"the {name} must be {dtype} on {device}, got "
                             f"{t.dtype} on {t.device}")
    if cs.idx.device != device:
        raise ValueError(f"the constraint pairs must be on {device}")
    if torch.is_grad_enabled() and (ref.requires_grad
                                    or state.requires_grad):
        raise ValueError("the constraint kernel does not differentiate")
    max_iter = int(max_iter)
    if max_iter < 0:
        raise ValueError(f"max_iter must be at least 0, got {max_iter}")
    n_pairs = cs.num_constraints
    threads, _ = launch_plan(n_atoms, n_pairs, dtype)
    ref, state = ref.contiguous(), state.contiguous()
    out = torch.empty_like(state)
    sweeps = torch.empty(state.shape[:-2], dtype=torch.int64, device=device)
    n_replicas = sweeps.numel()
    if n_replicas == 0:
        return out, sweeps
    t = constraint_tables(cs)
    lib = _library()
    fn = (lib.constraint_shake_launch if kind == "shake"
          else lib.constraint_rattle_launch)
    ptrs = [None] * 3 if stats is None else [b.data_ptr() for b in stats]
    err = fn(ref.data_ptr(), state.data_ptr(), t.pairs.data_ptr(),
             t.length_sq.data_ptr(), t.two_im.data_ptr(),
             t.im_sum.data_ptr(), t.row_start.data_ptr(),
             t.row_pair.data_ptr(), t.row_weight.data_ptr(), n_atoms,
             n_pairs, n_replicas, threads, max_iter, float(threshold),
             float(omega), int(dtype == torch.float64), out.data_ptr(),
             sweeps.data_ptr(), *ptrs, device.index,
             torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"constraint_{kind} kernel launch failed: "
                           + lib.constraints_error_string(err).decode())
    (constraint_shake if kind == "shake" else constraint_rattle).launches += 1
    return out, sweeps


def constraint_shake(cs, x_ref, x_new, threshold, max_iter, omega,
                     stats=None):
    """SHAKE ``x_new`` [..., N, 3] along ``x_ref``'s directions, every
    replica to its own stop (error max |r^2 - d0^2| / d0^2 at most
    ``threshold``, or ``max_iter`` sweeps): (positions, sweeps [...])."""
    return _launch("shake", cs, x_ref, x_new, max_iter, threshold, omega,
                   stats)


def constraint_rattle(cs, x, v, threshold, max_iter, omega, stats=None):
    """RATTLE ``v`` [..., N, 3] along ``x``'s constrained bonds, every
    replica to its own stop (error max |(v_i - v_j) . d| at most
    ``threshold``, or ``max_iter`` sweeps): (velocities, sweeps [...])."""
    return _launch("rattle", cs, x, v, max_iter, threshold, omega, stats)


constraint_shake.launches = 0
constraint_rattle.launches = 0
