"""The MD step's intra-ligand terms on the card: hand-written CUDA kernels
for the bonded terms and for the pairs, beside their plain twins.

The kernels are ``csrc/ligand_forces.cu`` (library ``ligand_forces``).
They replace no TPU kernel: the JAX package computes these terms with XLA
operations (``openmmgridforce_tpu/mm/forcefield.py``,
``openmmgridforce_tpu/ops/pairwise.py``). The source note gives the bound
and the design.

``ligand_bonded(positions, system)`` is the bonded terms' wrapper: a CPU
tensor takes the plain twin, ``mm/forcefield.py::bonded_energy_forces``; a
CUDA float32 or float64 tensor the kernel; anything else raises.
``ligand_pairs(table, positions, energy, forces)`` adds the intra-ligand
pairs of ``table`` to a step's ``energy`` and ``forces``: on the CPU
through the plain twin, ``ops/pairwise.py::pair_energy_forces``, on the
card in one kernel whose epilogue makes the sums. Each wrapper's
``launches`` counts its kernel's launches.

The kernels read the System's own index and parameter tensors and two
per-atom tables, built on the host once and cached by the identity of the
tensors they are made from (``ops/scatter.py::cached``, which holds the
row sums' tables too), so that a recording finds them without a
synchronisation: ``bonded_table`` (the rows of force each atom receives,
of the twin's ``mm/forcefield.py::bonded_rows``, in ``row_table``'s
order) and ``pair_partners`` (each atom's live partners, both directions
of every pair, with the table's qq, sigma and epsilon). A block stages
them in shared memory with its replicas' positions; the pair table is
read from device memory instead where it does not fit there.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..units import COULOMB_CONST
from .pairwise import PairTable, pair_energy_forces
from .scatter import cached, row_table

WARP = 32
# threads a block, at most (the kernels' bound is 256; a replica needs a
# warp): the bonded kernel's 1000 blocks of the MD cells fit the card in
# one wave at 128 threads (two terms a thread) and take two at 256, which
# measured 21% slower (csrc/ligand_forces.cu)
BONDED_THREADS = 128
PAIR_THREADS = 256
MAX_SHARED = 232_448      # bytes of shared memory a block may use (H100)


class BondedTable(NamedTuple):
    """Atom n receives the rows ``rows[row_start[n]:row_start[n + 1]]`` of
    the bonded terms' forces, in that order (int32, on the System's
    device)."""

    row_start: torch.Tensor   # [N + 1]
    rows: torch.Tensor        # [2B + 3A + 4T]


class PairPartners(NamedTuple):
    """Atom i's live partners are the entries ``start[i]:start[i + 1]``,
    in increasing order of partner, each (qq, sigma, epsilon, partner):
    the first three as the dense table holds them, the partner's index as
    a value (exact: N is below 2**24), so that an entry is one or two
    16-byte loads (start int32, entries in the table's dtype, on its
    device)."""

    start: torch.Tensor       # [N + 1]
    entries: torch.Tensor     # [E, 4]


def _check_terms(system):
    """Raises where the System's terms are not what the kernel reads."""
    terms = (("bond", system.bond_idx, 2, (system.bond_k, system.bond_r0)),
             ("angle", system.angle_idx, 3,
              (system.angle_k, system.angle_t0)),
             ("torsion", system.torsion_idx, 4,
              (system.torsion_k, system.torsion_per,
               system.torsion_phase)))
    for name, idx, width, params in terms:
        if idx.dtype != torch.int64 or idx.dim() != 2 \
                or idx.shape[1] != width:
            raise ValueError(f"{name}_idx must be int64 [n, {width}], got "
                             f"{idx.dtype} {tuple(idx.shape)}")
        if any(p.shape != idx.shape[:1] for p in params):
            raise ValueError(f"the {name} parameters must be "
                             f"[{idx.shape[0]}]")


def bonded_table(system, n_atoms: int) -> BondedTable:
    """The bonded kernel's per-atom table of rows, built on the host once
    per System's index tensors and ``n_atoms``."""
    # the twin's own row order (the mm package imports this module)
    from ..mm.forcefield import bonded_rows

    def build():
        _check_terms(system)
        ids = bonded_rows(system)
        host = ids.cpu().numpy()
        if host.size and (host.min() < 0 or host.max() >= n_atoms):
            raise ValueError(f"a bonded term names an atom outside "
                             f"[0, {n_atoms})")
        table = row_table(ids, n_atoms)
        counts = (table < len(host)).sum(1)
        start = np.concatenate([[0], np.cumsum(counts)])
        dev = system.bond_idx.device
        return BondedTable(
            row_start=torch.as_tensor(start, dtype=torch.int32, device=dev),
            rows=torch.as_tensor(table[table < len(host)], dtype=torch.int32,
                                 device=dev))

    keys = (system.bond_idx, system.angle_idx, system.torsion_idx)
    return cached(keys, ("bonded", int(n_atoms)), build)


def pair_partners(table: PairTable) -> PairPartners:
    """The pair kernel's per-atom lists of live partners, built on the host
    once per pair table. The table's mask must be 1 or 0 above the
    diagonal and 0 on and below it, as ``build_pair_table`` makes it."""
    def build():
        mask = table.mask.cpu().numpy()
        n = mask.shape[0]
        if mask.shape != (n, n) or not np.isin(mask, (0.0, 1.0)).all() \
                or np.tril(mask).any():
            raise ValueError("the pair kernel takes a mask of 1 or 0 above "
                             "the diagonal and 0 elsewhere")
        i, j = np.nonzero(mask)                 # i < j, row-major
        params = [t.cpu().numpy()[i, j] for t in
                  (table.qq, table.sigma, table.epsilon)]
        atom = np.concatenate([i, j])
        other = np.concatenate([j, i])
        order = np.lexsort((other, atom))       # by atom, then partner
        counts = np.bincount(atom, minlength=n)
        entries = np.stack([np.concatenate([p, p]) for p in params]
                           + [other.astype(np.float64)], -1)[order]
        dev = table.qq.device
        return PairPartners(
            start=torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                                  dtype=torch.int32, device=dev),
            entries=torch.as_tensor(entries, dtype=table.qq.dtype,
                                    device=dev).reshape(-1, 4))

    keys = (table.qq, table.sigma, table.epsilon, table.mask)
    return cached(keys, "pairs", build)


# ----------------------------------------------------------------------
# The launch plan
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How a kernel tiles a launch: ``replicas`` whole replicas a block,
    ``threads`` threads (a warp at least for each replica's energy), and
    ``shared_bytes`` of shared memory a block, ``table_bytes`` of them the
    per-atom tables a block stages once (0: read from device memory)."""

    replicas: int
    threads: int
    shared_bytes: int
    table_bytes: int

    def blocks(self, n_replicas: int) -> int:
        return -(-int(n_replicas) // self.replicas)


def launch_plan(work: int, per_replica: int, table: int, threads: int,
                kernel: str) -> LaunchPlan:
    """The plan of a kernel whose replica gives its threads ``work`` items
    at once (atoms, or terms) and stages ``per_replica`` bytes beside the
    ``table`` bytes a block stages once: as many replicas a block as fill
    ``threads`` threads (one at least, and a warp each for its energy), in
    whole warps. Raises where one replica and the table do not fit a
    block's shared memory."""
    if table + per_replica > MAX_SHARED:
        raise ValueError(f"the {kernel} kernel stages {per_replica} bytes a "
                         f"replica and {table} bytes of tables in shared "
                         f"memory; a block has {MAX_SHARED}")
    replicas = max(1, min(threads // WARP, threads // max(int(work), 1),
                          (MAX_SHARED - table) // per_replica))
    used = max(replicas * int(work), WARP * replicas)
    return LaunchPlan(replicas, min(threads, -(-used // WARP) * WARP),
                      table + replicas * per_replica, table)


def bonded_plan(system, n_atoms: int, dtype) -> LaunchPlan:
    """The bonded kernel's plan: a replica stages its positions, its rows
    of force and its terms' energies; a block the rows' per-atom table."""
    b, a, t = (len(system.bond_idx), len(system.angle_idx),
               len(system.torsion_idx))
    rows = 2 * b + 3 * a + 4 * t
    item = torch.finfo(dtype).bits // 8
    return launch_plan(max(n_atoms, b + a + t),
                       (3 * n_atoms + 3 * rows + b + a + t) * item,
                       (n_atoms + 1 + rows) * 4, BONDED_THREADS,
                       "ligand_bonded")


def pair_plan(n_atoms: int, n_entries: int, dtype) -> LaunchPlan:
    """The pair kernel's plan: a replica stages its positions and its
    atoms' energies; a block the partner table, where it fits beside one
    replica (else the kernel reads it from device memory)."""
    item = torch.finfo(dtype).bits // 8
    per_replica = 4 * n_atoms * item
    table = 4 * n_entries * item + (n_atoms + 1) * 4
    if table + per_replica > MAX_SHARED:
        table = 0
    return launch_plan(n_atoms, per_replica, table, PAIR_THREADS,
                       "ligand_pairs")


# ----------------------------------------------------------------------
# The kernels
# ----------------------------------------------------------------------

def _declare(lib):
    """Declares the C entry points of the kernels' shared library."""
    lib.ligand_bonded_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        + [ctypes.c_int, ctypes.c_void_p])
    lib.ligand_bonded_launch.restype = ctypes.c_int
    lib.ligand_pairs_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_double, ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p])
    lib.ligand_pairs_launch.restype = ctypes.c_int
    lib.ligand_forces_error_string.argtypes = [ctypes.c_int]
    lib.ligand_forces_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library():
    """The kernels' shared library, built at first use."""
    from .. import cuda_build

    return _declare(cuda_build.load("ligand_forces"))


def _raise_on(err, kernel):
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           + _library().ligand_forces_error_string(err)
                           .decode())


def _check_cuda(kernel, positions, tensors):
    """Raises where the kernel does not take ``positions`` [..., N, 3] and
    the float ``tensors`` it reads beside them."""
    dtype, device = positions.dtype, positions.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the {kernel} kernel takes float32 or float64, "
                         f"got {dtype}")
    if positions.dim() < 2 or positions.shape[-1] != 3:
        raise ValueError(f"positions must be [..., N, 3], got "
                         f"{tuple(positions.shape)}")
    if device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {device}")
    if torch.is_grad_enabled() and positions.requires_grad:
        raise ValueError(f"the {kernel} kernel does not differentiate; "
                         f"mm/system.py::potential_energy does")
    for name, t in tensors.items():
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"{name} must be {dtype} on {device}, got "
                             f"{t.dtype} on {t.device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def ligand_bonded(positions, system):
    """Energy [...] and forces [..., N, 3] of the System's bonded terms at
    ``positions`` [..., N, 3]: the twin on the CPU, the kernel on the
    card."""
    if positions.device.type == "cpu":
        # the twin (the mm package imports this module)
        from ..mm.forcefield import bonded_energy_forces

        return bonded_energy_forces(positions, system)
    params = {name: getattr(system, name) for name in (
        "bond_k", "bond_r0", "angle_k", "angle_t0", "torsion_k",
        "torsion_per", "torsion_phase")}
    _check_cuda("ligand_bonded", positions, params)
    idx = [system.bond_idx, system.angle_idx, system.torsion_idx]
    if any(t.device != positions.device for t in idx):
        raise ValueError(f"the System's terms must be on {positions.device}")
    x = positions.contiguous()
    n_atoms = x.shape[-2]
    energy = x.new_empty(x.shape[:-2])
    forces = torch.empty_like(x)
    n_replicas = energy.numel()
    if n_replicas == 0 or n_atoms == 0:
        return energy.zero_(), forces
    plan = bonded_plan(system, n_atoms, x.dtype)
    table = bonded_table(system, n_atoms)
    p = {k: v.contiguous() for k, v in params.items()}
    idx = [t.contiguous() for t in idx]
    err = _library().ligand_bonded_launch(
        x.data_ptr(), idx[0].data_ptr(), p["bond_k"].data_ptr(),
        p["bond_r0"].data_ptr(), idx[1].data_ptr(), p["angle_k"].data_ptr(),
        p["angle_t0"].data_ptr(), idx[2].data_ptr(),
        p["torsion_k"].data_ptr(), p["torsion_per"].data_ptr(),
        p["torsion_phase"].data_ptr(), len(idx[0]), len(idx[1]),
        len(idx[2]), table.row_start.data_ptr(), table.rows.data_ptr(),
        n_replicas, n_atoms, plan.replicas, plan.threads,
        int(x.dtype == torch.float64), energy.data_ptr(), forces.data_ptr(),
        x.device.index, _stream(x.device))
    _raise_on(err, "ligand_bonded")
    ligand_bonded.launches += 1
    return energy, forces


ligand_bonded.launches = 0


def ligand_pairs(table: PairTable, positions, energy, forces):
    """(``energy`` + the pairs' energy [...], ``forces`` + their forces
    [..., N, 3]) of ``table``'s pairs at ``positions`` [..., N, 3]: the
    twin and two sums on the CPU, one kernel on the card."""
    if positions.device.type == "cpu":
        e_p, f_p = pair_energy_forces(table, positions)
        return energy + e_p, forces + f_p
    _check_cuda("ligand_pairs", positions,
                {"qq": table.qq, "sigma": table.sigma,
                 "epsilon": table.epsilon, "energy": energy,
                 "forces": forces})
    x = positions.contiguous()
    n_atoms = x.shape[-2]
    if energy.shape != x.shape[:-2] or forces.shape != x.shape:
        raise ValueError(f"energy {tuple(energy.shape)} and forces "
                         f"{tuple(forces.shape)} do not match positions "
                         f"{tuple(x.shape)}")
    if table.qq.shape != (n_atoms, n_atoms):
        raise ValueError(f"a pair table of {tuple(table.qq.shape)} for "
                         f"{n_atoms} atoms")
    n_replicas = energy.numel()
    if n_replicas == 0 or n_atoms == 0:
        return energy.clone(), forces.clone()
    pair_plan(n_atoms, 0, x.dtype)    # raises where a replica cannot fit
    partners = pair_partners(table)
    n_entries = len(partners.entries)
    plan = pair_plan(n_atoms, n_entries, x.dtype)
    e_in, f_in = energy.contiguous(), forces.contiguous()
    e_out, f_out = torch.empty_like(e_in), torch.empty_like(f_in)
    err = _library().ligand_pairs_launch(
        x.data_ptr(), partners.start.data_ptr(), partners.entries.data_ptr(),
        n_entries, int(plan.table_bytes > 0), COULOMB_CONST, n_replicas,
        n_atoms, plan.replicas, plan.threads, int(x.dtype == torch.float64),
        e_in.data_ptr(), f_in.data_ptr(), e_out.data_ptr(), f_out.data_ptr(),
        x.device.index, _stream(x.device))
    _raise_on(err, "ligand_pairs")
    ligand_pairs.launches += 1
    return e_out, f_out


ligand_pairs.launches = 0
