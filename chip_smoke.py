#!/usr/bin/env python
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths (openmmgridforce_tpu_torch) at full width.
Two are a 1000-step classic-Langevin segment of 1000 ligand replicas on
three fused receptor grids: the value path (grids from the hand-written
values kernel, cubic B-spline packs) and the derivative path (grids with
27 derivatives from the hand-written derivative kernel and the chain
rules, triquintic Chebyshev packs, Hermite-row packs beside them). The
third is the BPMF sampler (bpmf_path): value grids packed slab by slab
into one fused table, an HBonds-constrained 21-state 300-600 K ladder at
2 fs, equilibration in drain rounds, then trials of replica-exchange
sweeps, genetic-MC sweeps and MD segments, at cut depth. api_path runs
the compat API (openmmgridforce_tpu_torch.api) on the same complex in
float64: grids auto-generated through Contexts on the receptor system
(float64 values and derivatives, a tiled file), the ligand's getState on
the card against a host Context, Langevin steps recorded and eager,
minimizeEnergy, and a streamed Context on the tiled files. Then the
out-of-core path: float64 generation through the kernels' float64
instantiations, grids generated tile by tile into OMGTILE files (the bench
box, and the reference's 520 x 695 x 578-point stress box, three 0.84 GB
files in a temporary directory deleted at the end), streamed evaluation
over the native tile cache against the whole grids on the card, and a
100-replica Langevin run of StreamedBatchMD on the stress files. Both
kernels are built from the checkout and held against their plain PyTorch
twins first: on ragged shapes down to one point and one atom, then at the
paths' full shapes, where each is timed beside its bound, its launch shape
and the instruction counts of its atom loop. Every MD segment runs as
replays of CUDA graphs of blocks of steps; each path also times (and
profiles) the same segment as eager launches, and segment_graph_check
holds the two trajectories against each other under the same explicit
noise (the constrained ladder with its sweeps stopped on the device by a
WHILE node, and a failed capture must raise). twofloat_check and
semantics_check run the double-float32 tier and the alternate kernel
semantics on the card against float64 on the host. Every
phase prints a JSON line; the last line is {"ok": true, "device": {...}}.
Any failed gate raises and the script exits non-zero. Without a CUDA device
it exits non-zero and prints no result.

    python3 chip_smoke.py [--seed N] [--stream-steps N]

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N_LIGAND = 47
N_RECEPTOR = 9133
N_REPLICAS = 1000
N_STEPS = 1000
N_WARMUP = 50
N_EVAL_POSES = 256
SPACING = 0.025       # nm
MARGIN = 1.0          # nm around the ligand's bounds
GRID_CAP = 41840.0
GRID_TYPES = ("charge", "ljr", "lja")
RECEPTOR_GAP = 0.7          # nm, least receptor-ligand atom distance
RECEPTOR_CHARGE_SD = 0.1    # e
H100_FP32_FLOPS = 67e12       # dense FP32 peak, H100 SXM at 700 W
# FP64 outside the tensor cores, H100 SXM at 700 W (NVIDIA's data sheet):
# half the FP32 rate, and no special-function pipe for float64
H100_FP64_FLOPS = 34e12
H100_BYTES_PER_S = 3.35e12
# rsqrt runs on the special-function (MUFU) pipe: 16 results per SM per
# clock against 256 FP32 operations (128 FMA lanes), so 1/16 of the peak
H100_MUFU_PER_S = H100_FP32_FLOPS / 16
# FP32 operations that the values kernel's function needs, with the work
# shared along z (the points of one z-column share dx, dy and dx^2 + dy^2
# for an atom). Per point-atom pair: dz, dz^2 + (dx^2 + dy^2) (2), the
# clamp, the rsqrt (charge) or the reciprocal that gives 1/r^2 (ljr, lja),
# the power (0, 3 or 2 multiplies), the multiply by K and the add into the
# sum. Per column-atom pair: 2 subtractions and 3 for dx^2 + dy^2. (One
# point per thread and every power from the rsqrt, as counted before the
# kernel tiled z, was 12 / 16 / 15.)
GRIDGEN_OPS_PER_PAIR = {"charge": 7, "ljr": 10, "lja": 9}
GRIDGEN_OPS_PER_COLUMN_ATOM = 5
# FP64 operations a pair of the float64 values kernel needs: the count
# above with the rsqrt (charge) or the reciprocal (ljr, lja) carried to
# double precision in place of its one operation. FP64 has no
# special-function pipe: a MUFU.RSQ64H / MUFU.RCP64H gives a seed of about
# 23 bits from the high word (on the MUFU pipe, not counted), and the
# fewest FP64 operations (an FMA two) that finish it to a faithfully
# rounded double (the seed's 2^-23 cubed is below 2^-53) are one
# third-order Newton step: for the rsqrt, t = x y, e = 1 - t y,
# p = 1/2 + 3/8 e, y + (e y) p, a multiply, two FMAs, a multiply and an
# FMA, 8 operations; for the reciprocal, e = 1 - x y, e = e + e e,
# y = y + y e, three FMAs, 6 operations. (The kernel's __drcp_rn adds a
# rounding step, two FMAs, for the correctly rounded result: work of the
# implementation, not of the function.) So 7 - 1 + 8, 10 - 1 + 6 and
# 9 - 1 + 6.
GRIDGEN_F64_OPS_PER_PAIR = {"charge": 14, "ljr": 15, "lja": 14}
# FP32 operations per pair that the derivative kernel's function needs,
# every multiply, add, subtract and max counted once (an FMA is two), with
# the work shared: 3 for the displacement, 6 for the clamped r^2, 0 / 4 / 3
# multiplies for 1/r^m by squaring, 1 for K / r^m, 6 for K / r^(m+n) with
# n = 1..6, 15 for the cascade combinations (each folds to one constant of
# the grid type times K / r^(m+n)), 6 direction cosines and squares, 81
# for the 27 terms with every direction product formed once, and 27 to add
# them in. This is the cost of the package's plain twin
# (ops/cuda_gridgen_derivs.py::pair_derivative_terms), which
# tests/test_torch_package.py traces against this table.
DERIVS_OPS_PER_PAIR = {"charge": 145, "ljr": 149, "lja": 148}
# Kernel times per grid (charge, ljr, lja) before both kernels were
# redesigned: one point per thread, the cascade unfolded. NVIDIA H100 80GB
# HBM3, 700.00 W, this script's kernel_check at the same shapes.
PREVIOUS_MS = {
    "gridgen_values": {"charge": 7.005, "ljr": 8.717, "lja": 7.880},
    "gridgen_derivs": {"charge": 100.945, "ljr": 103.532, "lja": 100.243}}
# Ragged shapes for both kernels: grids and atom counts that are multiples
# of no tile, block or partial, down to one point and one atom
RAGGED_COUNTS = ((1, 1, 1), (2, 3, 5), (5, 7, 3), (3, 4, 130))
RAGGED_ATOMS = (1, 7, 129, 300)
RAGGED_SPACING = (0.03, 0.035, 0.025)
RAGGED_ORIGIN = (0.0, -0.2, 0.3)
RAGGED_CAP = 800.0
N_DERIV_SLOTS = 27
# bpmf_path: the reference BPMF configuration (tools/bpmf_reference_input.json)
# at full width; depth cut to BPMF_EQUIL_STEPS of its 5,000 equilibration
# steps and BPMF_TRIALS of its 100 trials
BPMF_STATES = 21
BPMF_T_MIN, BPMF_T_HIGH = 300.0, 600.0
BPMF_DT = 0.002             # ps
BPMF_H_MASS = 4.0
BPMF_NSTEP_MD = 200
BPMF_REPX = 5
BPMF_GMC = 2
BPMF_EQUIL_STEPS = 1000
BPMF_EQUIL_REFERENCE = 5000
BPMF_DRAIN_ROUNDS = 2
BPMF_TRIALS = 10
BPMF_TRIALS_REFERENCE = 100
# the example's remedies for capped-well fusion (its --friction help text)
BPMF_FRICTION = 5.0
# receptor atoms >= 1.3 nm from the ligand on this path: with
# RECEPTOR_GAP's 0.7 nm the hot rungs carry ligand atoms into capped
# receptor wells within the run (the "charge fusion" that
# synthetic_complex describes), exchanges pass the fused conformations
# down the ladder, and a fused replica's 2 fs integration diverges
BPMF_RECEPTOR_GAP = 1.3
BPMF_X_CHUNK = 16
DERIV_CHECK_PLANES = 3   # x-planes at each of the grid's start, middle, end
FAR_FIELD = 0.3          # nm from every receptor atom
F64_GATE = 1e-10         # float64 kernels against their float64 twins
# the out-of-core path: the reference's tiled stress box
# (test_bspline_tiled_highres.py:46-57, bench_canonical.py:50-52), centred
# on the ligand
STRESS_COUNTS = (520, 695, 578)
STRESS_SPACING = 0.005   # nm
TILE_SIZE = 32
NATIVE_BUDGET = 256 << 20     # bytes of the native tile cache
N_SCREEN_POSES = 4096
SCREEN_MARGIN = 32            # cells around a docking pose's region
N_TRIQUINTIC_POSES = 256
# streamed_path: bench_canonical.py's stress-md protocol (:752-896)
STREAM_REPLICAS = 100
STREAM_DT = 0.00025           # ps
STREAM_FRICTION = 5.0
STREAM_REFRESH = 50
STREAM_MARGIN = 16            # cells of drift headroom a side
STREAM_WARM = 100
STREAM_DRAIN_ROUNDS = 2
STREAM_DRAIN_STEPS = 500
STREAM_DRAIN_K = 1000.0
# timed steps, cut from the protocol's 1,000 (--stream-steps restores
# them): as the 100 clouds spread past their 16-cell margins the region
# policy splits them into more groups, each its own eager segment, and
# the later steps cost the most (PERF.md)
STREAM_STEPS = 400
STREAM_STEPS_REFERENCE = 1000
STREAM_PROFILED_STEPS = 8
# recorded segments (CUDA graphs of blocks of steps) against the same
# segment run as eager launches: the eager rate is timed over a window of
# EAGER_STEPS; segment_graph_check holds graph and eager trajectories under
# the same explicit noise to GRAPH_GATE (float32, nm and nm/ps)
EAGER_STEPS = 100
GRAPH_CHECK_STEPS = 50
GRAPH_CHECK_CONSTRAINED_STEPS = 20
GRAPH_CHECK_STREAM_STEPS = 20
GRAPH_GATE = 1e-6
# bpmf_path: MD segments timed as recordings (with fixed-order and with
# atomic row sums) and eagerly; block replays timed back to back
BPMF_CANDIDATE_SEGMENTS = 2
BPMF_REPLAYS = 25
# api_path: the compat API at the BPMF complex's width (float64, as the
# JAX package's Context): Langevin at 300 K, friction 1/ps, 2 fs, HBonds,
# with T_inst sampled every API_CHUNK steps; minimizeEnergy(150, 20.0) as
# tests/test_api.py; Verlet steps of a streamed Context
API_STEPS = 1000
API_CHUNK = 20
API_MIN_ITERATIONS = 150
API_MIN_TOLERANCE = 20.0
API_STREAM_STEPS = 200
# semantics_check / twofloat_check: the accuracy tier on the card
TWOFLOAT_N = 1 << 20
COMPENSATED_GATE = 2e-6      # tests/test_compensated.py's rtol
N_COMPENSATED_POSES = 256

# element -> (mass amu, sigma nm, epsilon kJ/mol, valence)
_ELEMENTS = {"C": (12.011, 0.34, 0.36, 4), "N": (14.007, 0.325, 0.71, 3),
             "O": (15.999, 0.296, 0.88, 2), "H": (1.008, 0.26, 0.066, 1)}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"gate failed: {msg}")


# ----------------------------------------------------------------------
# The synthetic complex
# ----------------------------------------------------------------------

def _graph_distances(n, bonds):
    """All-pairs bond-graph distances (BFS from every atom) [n, n]."""
    nbr = [[] for _ in range(n)]
    for i, j in bonds:
        nbr[i].append(j)
        nbr[j].append(i)
    dist = np.full((n, n), 99, dtype=np.int64)
    for s in range(n):
        dist[s, s] = 0
        frontier = [s]
        while frontier:
            nxt = []
            for a in frontier:
                for b in nbr[a]:
                    if dist[s, b] == 99:
                        dist[s, b] = dist[s, a] + 1
                        nxt.append(b)
            frontier = nxt
    return nbr, dist


def _grow_ligand(rng, n_atoms):
    """Atom elements, coordinates [n, 3] nm and bonds of a branched tree:
    heavy atoms first, then hydrogens on free valences."""
    n_heavy = round(n_atoms * 20 / 47)
    elems = ["C"] + list(rng.choice(["C", "C", "C", "C", "N", "O"],
                                    n_heavy - 1))
    elems += ["H"] * (n_atoms - n_heavy)
    x = np.zeros((n_atoms, 3))
    bonds, used = [], np.zeros(n_atoms, dtype=np.int64)
    for a in range(1, n_atoms):
        heavy = elems[a] != "H"
        free = [p for p in range(a) if elems[p] != "H"
                and used[p] < _ELEMENTS[elems[p]][3] - (1 if heavy else 0)]
        if not free:
            free = [p for p in range(a) if elems[p] != "H"
                    and used[p] < _ELEMENTS[elems[p]][3]]
        if not free:
            raise ValueError("ligand tree has no free valence left")
        parent = int(rng.choice(free))
        length = 0.15 if heavy else 0.109
        _, dist = _graph_distances(a, bonds)
        best, best_score = None, -np.inf
        for _ in range(200):
            u = rng.standard_normal(3)
            cand = x[parent] + length * u / np.linalg.norm(u)
            score = np.inf
            for b in range(a):
                gd = dist[parent, b] + 1       # graph distance child-b
                if gd <= 2:
                    need = 0.22 if gd == 2 else 0.0
                elif gd == 3:
                    need = 0.25
                else:
                    need = 0.28 if "H" in (elems[a], elems[b]) else 0.34
                score = min(score, np.linalg.norm(cand - x[b]) - need)
            if score > best_score:
                best, best_score = cand, score
            if score >= 0.0:
                break
        x[a] = best
        bonds.append((parent, a))
        used[parent] += 1
        used[a] += 1
    return elems, x, bonds


def synthetic_complex(seed: int = 0, n_ligand: int = N_LIGAND,
                      n_receptor: int = N_RECEPTOR, gap: float = RECEPTOR_GAP,
                      charge_sd: float = RECEPTOR_CHARGE_SD):
    """A seeded ligand/receptor complex of the BPMF workload's sizes.

    The real AMBER ligand and receptor files of the benchmark are not in
    the repository, so this builds their stand-ins (``load_prmtop`` itself
    is covered by the CPU tests). The ligand is an AMBER-like tree of
    C/N/O/H atoms: bonds, angles and proper torsions from the bond graph,
    1-2/1-3/1-4 exclusions and 1-4 pairs scaled by scee 1.2 and scnb 2.0,
    charges near neutral, coordinates consistent with the bond lengths and
    spanning about 1 nm. The receptor is a rigid cloud of atoms at protein
    density (100 atoms/nm^3) in a shell around the ligand, every atom at
    least ``gap`` nm from every ligand atom, with charges of standard
    deviation ``charge_sd`` e. The tanh cap bounds a ligand atom's LJ wall at
    a few to ~80 kJ/mol while the capped Coulomb well reaches thousands,
    so closer or more strongly charged receptor atoms let replicas fall
    into those wells ("charge fusion") within one segment.

    Returns (ligand AmberTopology, ligand coords [n, 3] nm,
    receptor AmberTopology, receptor coords [m, 3] nm).
    """
    from openmmgridforce_tpu_torch.mm.amber import AmberTopology

    rng = np.random.default_rng(seed)
    elems, x, bonds = _grow_ligand(rng, n_ligand)
    n = n_ligand
    nbr, dist = _graph_distances(n, bonds)
    params = np.array([_ELEMENTS[e][:3] for e in elems])
    charges = np.where(np.array(elems) == "H", 0.12, -0.1) \
        + 0.15 * rng.standard_normal(n)
    charges -= charges.mean()

    bond_idx = np.array(bonds, dtype=np.int64)
    bond_r0 = np.linalg.norm(x[bond_idx[:, 0]] - x[bond_idx[:, 1]], axis=1)
    has_h = np.array([elems[i] == "H" or elems[j] == "H" for i, j in bonds])
    bond_k = np.where(has_h, 284512.0, 251040.0)

    angles = [(i, j, k) for j in range(n) for i in nbr[j] for k in nbr[j]
              if i < k]
    angle_idx = np.array(angles, dtype=np.int64).reshape(-1, 3)
    a = x[angle_idx[:, 0]] - x[angle_idx[:, 1]]
    b = x[angle_idx[:, 2]] - x[angle_idx[:, 1]]
    angle_t0 = np.arccos(np.clip(
        (a * b).sum(1) / np.linalg.norm(a, axis=1)
        / np.linalg.norm(b, axis=1), -1.0, 1.0))
    angle_k = np.full(len(angles), 418.4)

    torsions = [(i, j, k, l) for j, k in bonds for i in nbr[j] if i != k
                for l in nbr[k] if l != j]
    torsion_idx = np.array(torsions, dtype=np.int64).reshape(-1, 4)
    nt = len(torsions)
    torsion_k = rng.uniform(0.5, 4.0, nt)
    torsion_per = rng.integers(1, 4, nt).astype(np.float64)
    torsion_phase = np.where(rng.random(nt) < 0.5, 0.0, np.pi)

    iu, ju = np.triu_indices(n, k=1)
    near = dist[iu, ju] <= 3
    exclusions = [(int(i), int(j)) for i, j in zip(iu[near], ju[near])]
    is14 = dist[iu, ju] == 3
    pairs14 = np.stack([iu[is14], ju[is14]], axis=1).astype(np.int64)

    lig = AmberTopology(
        natom=n, masses=params[:, 0], charges=charges, sigmas=params[:, 1],
        epsilons=params[:, 2], atom_names=list(elems),
        residue_labels=["LIG"], residue_pointers=np.array([1]),
        bond_idx=bond_idx, bond_k=bond_k, bond_r0=bond_r0,
        angle_idx=angle_idx, angle_k=angle_k, angle_t0=angle_t0,
        torsion_idx=torsion_idx, torsion_k=torsion_k,
        torsion_per=torsion_per, torsion_phase=torsion_phase,
        exclusions=exclusions, pairs14=pairs14,
        scee=np.full(len(pairs14), 1.2), scnb=np.full(len(pairs14), 2.0))

    # receptor: uniform at protein density in a ball around the ligand,
    # minus a ``gap`` envelope around every ligand atom
    center = x.mean(0)
    r_out = (3.0 * (n_receptor / 100.0 + 4.0) / (4.0 * np.pi)) ** (1 / 3) \
        + np.linalg.norm(x - center, axis=1).max()
    rec = np.zeros((0, 3))
    while len(rec) < n_receptor:
        u = rng.standard_normal((4 * n_receptor, 3))
        u *= (r_out * rng.random(len(u)) ** (1 / 3)
              / np.linalg.norm(u, axis=1))[:, None]
        cand = center + u
        dmin = np.linalg.norm(cand[:, None, :] - x[None], axis=2).min(1)
        rec = np.concatenate([rec, cand[dmin >= gap]])
    rec = rec[:n_receptor]
    rel = rng.choice(["C", "C", "N", "O", "H", "H"], n_receptor)
    rparams = np.array([_ELEMENTS[e][:3] for e in rel])
    rq = charge_sd * rng.standard_normal(n_receptor)
    rq -= rq.mean()
    z2 = np.zeros((0, 2), dtype=np.int64)
    z = np.zeros(0)
    receptor = AmberTopology(
        natom=n_receptor, masses=rparams[:, 0], charges=rq,
        sigmas=rparams[:, 1], epsilons=rparams[:, 2],
        atom_names=list(rel), residue_labels=["REC"],
        residue_pointers=np.array([1]), bond_idx=z2, bond_k=z, bond_r0=z,
        angle_idx=np.zeros((0, 3), np.int64), angle_k=z, angle_t0=z,
        torsion_idx=np.zeros((0, 4), np.int64), torsion_k=z,
        torsion_per=z, torsion_phase=z, exclusions=[], pairs14=z2, scee=z,
        scnb=z)
    return lig, x, receptor, rec


def grid_box(lig_crd):
    """Ligand bounds +- MARGIN at SPACING: (counts, origin)."""
    lo = lig_crd.min(0) - MARGIN
    counts = tuple(int(c) + 1 for c in
                   np.ceil((lig_crd.max(0) + MARGIN - lo) / SPACING))
    return counts, tuple(float(v) for v in lo)


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------

def _host_seconds(fn, reps):
    """Host seconds per call of ``fn``, which ends in a download."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def _cuda_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()                                   # warm-up
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    props = torch.cuda.get_device_properties(0)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "sm_count": props.multi_processor_count,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": False, "cudnn": False}})
    return smi, props.multi_processor_count


def phase_build():
    from openmmgridforce_tpu_torch import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build()
    ptxas = {name: [ln.strip() for ln in cuda_build.build_log(name)
                    .splitlines() if "registers" in ln or "spill" in ln]
             for name in cuda_build.LIBRARIES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_library_s": built, "ptxas": ptxas})
    for name, lines in ptxas.items():
        check(any("registers" in ln for ln in lines),
              f"{name}: ptxas reported no register count")
        for ln in lines:
            spilled = re.findall(r"(\d+) bytes spill", ln)
            check(all(int(b) == 0 for b in spilled),
                  f"{name} spills registers: {ln}")


def _sm_clock_under_load(torch, fn, launches=20):
    """The SM clock in MHz as nvidia-smi reads it while ``launches`` calls
    of ``fn`` are queued on the card (a diagnostic: the bounds assume the
    data sheet's boost clock)."""
    for _ in range(launches):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    torch.cuda.synchronize()
    fields = out.stdout.strip().splitlines()[0].split(",") if (
        out.returncode == 0 and out.stdout.strip()) else []
    try:
        return {"sm_mhz": float(fields[0]), "max_sm_mhz": float(fields[1])}
    except (IndexError, ValueError):
        return {"sm_mhz": None, "max_sm_mhz": None,
                "note": "nvidia-smi gave no clocks"}


def _entry_key(grid_type, f64=False):
    """The part of a kernel's mangled name that names its instantiation:
    the grid type and the scalar type."""
    return f"kernelILi{GRID_TYPES.index(grid_type)}E{'d' if f64 else 'f'}E"


def _launch_facts(name, module, counts, grid_type, sm_count, f64=False):
    """What a kernel_check line says about the launch beside its time:
    registers per thread (ptxas), blocks, resident blocks per SM (the CUDA
    runtime's occupancy query), and the waves the grid makes of them."""
    import torch
    from openmmgridforce_tpu_torch import cuda_build

    registers = [r for entry, r in cuda_build.kernel_registers(name).items()
                 if _entry_key(grid_type, f64) in entry]
    check(len(registers) == 1, f"{name}: no register count for {grid_type}")
    shape = module.launch_shape(
        counts, grid_type, dtype=torch.float64 if f64 else torch.float32)
    return {"registers": registers[0], "blocks": shape["blocks"],
            "threads": shape["threads"],
            "blocks_per_sm": shape["blocks_per_sm"],
            "waves": shape["blocks"] / (shape["blocks_per_sm"] * sm_count)}


_SASS_KINDS = ("FFMA", "FMUL", "FADD", "MUFU", "LDS", "DFMA", "DMUL", "DADD")
# instructions of the FP64 pipe: arithmetic, compares and min/max
_SASS_FP64 = ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX")


def inner_loop_counts(sass_text):
    """Per kernel of a ``cuobjdump -sass`` listing, the instructions of
    its hottest loop by kind: of the innermost loops (a backward branch
    with no other backward branch inside) that hold a MUFU instruction
    (one rsqrt or reciprocal per pair), the one with the most of them,
    which is the unrolled atom loop. Returns {function: {"instructions",
    kinds..., "other", "other_by_opcode", "per_pair"}}; a function without
    such a loop is left out."""
    out, name, code = {}, None, []

    def close():
        if name is None:
            return
        spans = [(tgt, at) for at, (op, tgt) in enumerate(code)
                 if tgt is not None and tgt <= at]
        best = None
        for lo, hi in spans:
            if any((a, b) != (lo, hi) and lo <= a and b <= hi
                   for a, b in spans):
                continue
            ops = [op for op, _ in code[lo:hi + 1]]
            n_mufu = sum(op.startswith("MUFU") for op in ops)
            if n_mufu and (best is None or n_mufu > best[0]):
                best = (n_mufu, ops)
        if best is None:
            return
        n_mufu, ops = best
        kinds = {k: sum(op.split(".")[0] == k for op in ops)
                 for k in _SASS_KINDS}
        other = {}
        for op in ops:
            if op.split(".")[0] not in _SASS_KINDS:
                other[op.split(".")[0]] = other.get(op.split(".")[0], 0) + 1
        fp64 = sum(op.split(".")[0] in _SASS_FP64 for op in ops)
        # FP64 operations, an FMA two (GRIDGEN_F64_OPS_PER_PAIR's count)
        flops = fp64 + sum(op.split(".")[0] == "DFMA" for op in ops)
        out[name] = {"instructions": len(ops), **kinds,
                     "other": len(ops) - sum(kinds.values()),
                     "other_by_opcode": other,
                     "per_pair": len(ops) / n_mufu,
                     "fp64": fp64, "fp64_per_pair": fp64 / n_mufu,
                     "fp64_ops_per_pair": flops / n_mufu}

    addr_index = {}
    for line in sass_text.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            close()
            name, code, addr_index = found.group(1), [], {}
            continue
        found = re.match(
            r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
            r"([^;]*);", line)
        if not found or name is None:
            continue
        addr, op, operands = found.groups()
        addr_index[int(addr, 16)] = len(code)
        target = None
        if op.split(".")[0] == "BRA":
            hexes = re.findall(r"0x([0-9a-f]+)", operands)
            if hexes:
                # a backward target is already indexed; a forward one is
                # not and stays None
                target = addr_index.get(int(hexes[-1], 16))
        code.append((op, target))
    close()
    return out


def phase_sass():
    """A diagnostic, gating nothing: instruction counts of each kernel's
    atom loop, float32 and float64 instantiations, from cuobjdump where
    the toolkit has it (for float64, the FP64 instructions a pair issues
    beside GRIDGEN_F64_OPS_PER_PAIR, the fewest its function needs)."""
    from openmmgridforce_tpu_torch import cuda_build

    for name in cuda_build.LIBRARIES:
        text = cuda_build.sass(name)
        if text is None:
            emit({"phase": "sass", "kernel": name,
                  "note": "no cuobjdump beside nvcc"})
            continue
        loops = inner_loop_counts(text)
        per_type, per_type_f64 = {}, {}
        for entry, counts in loops.items():
            for gt in GRID_TYPES:
                if _entry_key(gt) in entry:
                    per_type[gt] = counts
                if _entry_key(gt, f64=True) in entry:
                    per_type_f64[gt] = counts
        none = "no loop with a MUFU instruction found in the listing"
        emit({"phase": "sass", "kernel": name,
              "inner_loop_per_grid_type": per_type or none,
              "inner_loop_per_grid_type_f64": per_type_f64 or none,
              "fp64_ops_per_pair_needed": (GRIDGEN_F64_OPS_PER_PAIR
                                           if name == "gridgen_values"
                                           else None)})


def ragged_case(grid_type, counts, n_atoms, seed=53, device="cpu",
                dtype=None):
    """The atom table [A, 4] of one ragged-shape case: seeded atoms in and
    around the box of RAGGED_SPACING x counts at RAGGED_ORIGIN."""
    import torch
    from openmmgridforce_tpu_torch.ops.gridgen import receptor_atoms

    rng = np.random.default_rng([seed, n_atoms, *counts])
    lo = np.array(RAGGED_ORIGIN) - 0.3
    hi = (np.array(RAGGED_ORIGIN)
          + np.array(RAGGED_SPACING) * (np.array(counts) - 1) + 0.3)
    return receptor_atoms(
        grid_type, rng.uniform(lo, hi, (n_atoms, 3)),
        rng.uniform(-1, 1, n_atoms), rng.uniform(0.2, 0.35, n_atoms),
        rng.uniform(0.1, 1.0, n_atoms), dtype=dtype or torch.float32,
        device=device)


def phase_ragged(torch):
    """Both kernels against their twins on RAGGED_COUNTS x RAGGED_ATOMS,
    every grid type, at the gates of the big checks; and the values kernel
    exactly at the cap on an atom that sits on each grid's last point."""
    from openmmgridforce_tpu_torch.ops.cuda_gridgen import (
        gridgen_values, gridgen_values_plain)
    from openmmgridforce_tpu_torch.ops.cuda_gridgen_derivs import (
        gridgen_derivs, gridgen_derivs_plain)

    worst = {"gridgen_values": 0.0, "gridgen_derivs_f32": 0.0,
             "gridgen_derivs_f64": 0.0}
    cases, misses = 0, []
    for counts in RAGGED_COUNTS:
        geom = (counts, RAGGED_SPACING, RAGGED_ORIGIN)
        for n_atoms in RAGGED_ATOMS:
            for gt in GRID_TYPES:
                atoms = ragged_case(gt, counts, n_atoms, device="cuda")
                where = f"{gt} {counts} x {n_atoms} atoms"
                got = gridgen_values(atoms, *geom, gt, RAGGED_CAP)
                ref = gridgen_values_plain(atoms, *geom, gt, RAGGED_CAP)
                ok = (got.shape == ref.shape == counts
                      and bool(torch.isfinite(got).all()))
                err = float((got - ref).abs().max() / ref.abs().max())
                worst["gridgen_values"] = max(worst["gridgen_values"], err)
                if not ok or not err < 1e-5:
                    misses.append(f"gridgen_values {where}: {err}")
                got = gridgen_derivs(atoms, *geom, gt)
                ref = gridgen_derivs_plain(atoms, *geom, gt)
                ref64 = gridgen_derivs_plain(atoms.double(), *geom, gt)
                ok = (got.shape == counts + (N_DERIV_SLOTS,)
                      and bool(torch.isfinite(got).all()))
                got = got.reshape(-1, N_DERIV_SLOTS)
                e32 = float(_slot_err(got, ref).max())
                e64 = float(_slot_err(got, ref64).max())
                worst["gridgen_derivs_f32"] = max(
                    worst["gridgen_derivs_f32"], e32)
                worst["gridgen_derivs_f64"] = max(
                    worst["gridgen_derivs_f64"], e64)
                if not ok or not e32 < 5e-5 or not e64 < 2e-4:
                    misses.append(f"gridgen_derivs {where}: {e32} {e64}")
                cases += 1
        # an ljr atom on the grid's last point: exactly the cap there
        last = [c - 1 for c in counts]
        point = (torch.tensor(RAGGED_ORIGIN)
                 + torch.tensor(last) * torch.tensor(RAGGED_SPACING))
        on_atom = torch.cat([point, torch.ones(1)])[None].to("cuda")
        val = float(gridgen_values(on_atom, *geom, "ljr",
                                   RAGGED_CAP)[tuple(last)])
        if val != RAGGED_CAP:
            misses.append(f"cap on the last point of {counts}: {val}")
    torch.cuda.synchronize()
    emit({"phase": "ragged_shapes", "counts": RAGGED_COUNTS,
          "atoms": RAGGED_ATOMS, "cases_per_kernel": cases,
          "worst_rel_err": worst, "misses": misses})
    check(not misses, f"ragged shapes: {misses}")


def phase_kernel_check(torch, rec, rec_crd, counts, origin, sm_count):
    """The kernel against its plain twin at the main path's shapes."""
    from openmmgridforce_tpu_torch.ops import cuda_gridgen
    from openmmgridforce_tpu_torch.ops.cuda_gridgen import (
        gridgen_values, gridgen_values_plain)
    from openmmgridforce_tpu_torch.ops.gridgen import receptor_atoms

    spacing = (SPACING,) * 3
    n_points = counts[0] * counts[1] * counts[2]
    per_type = {}
    for gt in GRID_TYPES:
        atoms = receptor_atoms(gt, rec_crd, rec.charges, rec.sigmas,
                               rec.epsilons, device="cuda")
        args = (atoms, counts, spacing, origin, gt, GRID_CAP)
        got = gridgen_values(*args)
        ref = gridgen_values_plain(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        ms = _cuda_ms(torch, lambda: gridgen_values(*args), 5)
        plain_ms = _cuda_ms(torch, lambda: gridgen_values_plain(*args), 1)
        pairs = n_points * atoms.shape[0]
        columns = counts[0] * counts[1] * atoms.shape[0]
        bounds = {"fp32": (pairs * GRIDGEN_OPS_PER_PAIR[gt]
                           + columns * GRIDGEN_OPS_PER_COLUMN_ATOM)
                  / H100_FP32_FLOPS,
                  "mufu": pairs / H100_MUFU_PER_S,
                  "bytes": (atoms.numel() + n_points) * 4 / H100_BYTES_PER_S}
        bound_pipe = max(bounds, key=bounds.get)
        per_type[gt] = {"max_abs_err": err, "max_abs_ref": scale,
                        "rel_err": err / scale, "ms": ms,
                        "previous_ms": PREVIOUS_MS["gridgen_values"][gt],
                        "plain_ms": plain_ms,
                        "bound_ms": 1e3 * bounds[bound_pipe],
                        "bound_pipe": bound_pipe, "pairs": pairs,
                        "gpairs_per_s": pairs / ms / 1e6,
                        **_launch_facts("gridgen_values", cuda_gridgen,
                                        counts, gt, sm_count)}
        del got, ref

    # a grid point exactly on an atom caps at exactly grid_cap
    on_atom = torch.tensor([[0.1, 0.1, 0.1, 1.0]], device="cuda")
    cap_val = float(gridgen_values(on_atom, (3, 3, 3), (0.1,) * 3,
                                   (0.0,) * 3, "ljr", 500.0)[1, 1, 1])
    emit({"phase": "kernel_check", "kernel": "gridgen_values",
          "counts": counts, "atoms": int(rec_crd.shape[0]),
          "per_grid_type": per_type, "cap_on_atom": cap_val})
    for gt, r in per_type.items():
        check(r["rel_err"] < 1e-5, f"gridgen {gt}: rel err {r['rel_err']}")
    check(cap_val == 500.0, f"cap on atom gave {cap_val}, not 500.0")
    return per_type


def _slot_err(got, ref, rows=None):
    """Per derivative slot, max |got - ref| over max |ref| (over ``rows``
    when given); returns the [27] ratios as float64."""
    if rows is not None:
        got, ref = got[rows], ref[rows]
    num = (got.double() - ref.double()).abs().amax(0)
    return num / ref.double().abs().amax(0).clamp_min(1e-300)


def phase_kernel_check_derivs(torch, rec, rec_crd, counts, origin,
                              sm_count):
    """The derivative kernel against its plain twin at the main path's
    atoms and grid: the float32 twin over the whole grid, the float64 twin
    over slabs of x-planes at the grid's start, middle and end."""
    from openmmgridforce_tpu_torch.ops import cuda_gridgen_derivs
    from openmmgridforce_tpu_torch.ops.cuda_gridgen import (
        grid_point_positions)
    from openmmgridforce_tpu_torch.ops.cuda_gridgen_derivs import (
        gridgen_derivs, gridgen_derivs_plain)
    from openmmgridforce_tpu_torch.ops.gridgen import receptor_atoms

    spacing = (SPACING,) * 3
    nx, nyz = counts[0], counts[1] * counts[2]
    n_points = nx * nyz
    planes = min(DERIV_CHECK_PLANES, nx)
    starts = sorted({0, (nx - planes) // 2, nx - planes})
    slabs = [(x0 * nyz, (x0 + planes) * nyz) for x0 in starts]
    slab_rows = torch.cat([torch.arange(a, b, device="cuda")
                           for a, b in slabs])
    xyz = torch.as_tensor(rec_crd, dtype=torch.float32, device="cuda")
    per_type = {}
    for gt in GRID_TYPES:
        atoms = receptor_atoms(gt, rec_crd, rec.charges, rec.sigmas,
                               rec.epsilons, device="cuda")
        args = (atoms, counts, spacing, origin, gt)
        got = gridgen_derivs(*args).reshape(n_points, N_DERIV_SLOTS)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"gridgen_derivs {gt}: "
              "non-finite output")
        gridgen_derivs_plain(*args, stop=min(4096, n_points))   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref32 = gridgen_derivs_plain(*args)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        ref64 = torch.cat([gridgen_derivs_plain(atoms.double(), *args[1:],
                                                start=a, stop=b)
                           for a, b in slabs])
        # points of the slabs farther than FAR_FIELD from every atom
        pts = grid_point_positions(
            counts, torch.tensor(spacing, device="cuda"),
            torch.tensor(origin, dtype=torch.float32, device="cuda"),
            slab_rows)
        far = torch.cat([(torch.cdist(c, xyz).amin(1) > FAR_FIELD)
                         for c in pts.split(16384)])
        err32 = _slot_err(got, ref32)
        err64 = _slot_err(got[slab_rows], ref64)
        ms = _cuda_ms(torch, lambda: gridgen_derivs(*args), 3)
        pairs = n_points * atoms.shape[0]
        bounds = {"fp32": pairs * DERIVS_OPS_PER_PAIR[gt] / H100_FP32_FLOPS,
                  "mufu": pairs / H100_MUFU_PER_S,
                  "bytes": (atoms.numel() + n_points * N_DERIV_SLOTS) * 4
                  / H100_BYTES_PER_S}
        bound_pipe = max(bounds, key=bounds.get)
        per_type[gt] = {
            "max_abs_err": float((got - ref32).abs().max()),
            "rel_err_f32": float(err32.max()),
            "rel_err_f32_slot": int(err32.argmax()),
            "rel_err_f64": float(err64.max()),
            "rel_err_f64_slot": int(err64.argmax()),
            "far_points": int(far.sum()),
            "far_rel_err_f32": float(_slot_err(got[slab_rows],
                                               ref32[slab_rows], far).max()),
            "far_rel_err_f64": float(_slot_err(got[slab_rows], ref64,
                                               far).max()),
            "ms": ms, "previous_ms": PREVIOUS_MS["gridgen_derivs"][gt],
            "plain_ms": plain_ms,
            "bound_ms": 1e3 * bounds[bound_pipe], "bound_pipe": bound_pipe,
            "pairs": pairs, "gpairs_per_s": pairs / ms / 1e6,
            "tflops": pairs * DERIVS_OPS_PER_PAIR[gt] / ms / 1e9,
            **_launch_facts("gridgen_derivs", cuda_gridgen_derivs, counts,
                            gt, sm_count)}
        del got, ref32, ref64
    clock = _sm_clock_under_load(torch, lambda: gridgen_derivs(*args))
    emit({"phase": "kernel_check", "kernel": "gridgen_derivs",
          "counts": counts, "atoms": int(rec_crd.shape[0]),
          "f64_slab_points": int(slab_rows.numel()),
          "clock_under_load": clock, "per_grid_type": per_type})
    for gt, r in per_type.items():
        check(r["rel_err_f32"] < 5e-5, f"gridgen_derivs {gt}: slot "
              f"{r['rel_err_f32_slot']} is {r['rel_err_f32']} from the "
              "float32 twin")
        check(r["rel_err_f64"] < 2e-4, f"gridgen_derivs {gt}: slot "
              f"{r['rel_err_f64_slot']} is {r['rel_err_f64']} from the "
              "float64 twin")
    return per_type


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _reset_launches():
    from openmmgridforce_tpu_torch.ops.cuda_gridgen import gridgen_values
    from openmmgridforce_tpu_torch.ops.cuda_gridgen_derivs import (
        gridgen_derivs)

    gridgen_values.launches = 0
    gridgen_derivs.launches = 0
    return gridgen_values, gridgen_derivs


def _run_path(torch, phase, seed, lig, lig_crd, rec, rec_crd, counts,
              origin, n_replicas, n_steps, device, derivatives):
    """One path of the port from the synthetic complex to final replica
    states. ``derivatives`` False: value grids, B-spline packs. True:
    grids with 27 derivatives, triquintic Chebyshev packs, and the
    Hermite-row packs of the same grids beside them. Returns (system,
    binding, Hermite-row binding or None, states, launches of the path's
    kernel)."""
    from openmmgridforce_tpu_torch.grid import InterpolationMethod
    from openmmgridforce_tpu_torch.mm import (GridBinding, graphs,
                                              make_md_runner,
                                              system_from_amber)
    from openmmgridforce_tpu_torch.ops import gridgen
    from openmmgridforce_tpu_torch.ops.packed import (
        combine_hermite_packed, combine_packed_grids, pack_grid,
        pack_grid_hermite)
    from openmmgridforce_tpu_torch.parallel import (init_replica_states,
                                                    replica_temperatures)

    spacing = (SPACING,) * 3
    method = (InterpolationMethod.TRIQUINTIC if derivatives
              else InterpolationMethod.BSPLINE)
    values_kernel, derivs_kernel = _reset_launches()
    _sync(torch, device)
    t0 = time.perf_counter()
    grids = [gridgen.generate_grid(
        counts, spacing, origin, gt, rec_crd, rec.charges, rec.sigmas,
        rec.epsilons, grid_cap=GRID_CAP, compute_derivatives=derivatives,
        interp_method=method, device=device)
        for gt in GRID_TYPES]
    _sync(torch, device)
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    multi = combine_packed_grids([pack_grid(g) for g in grids])
    _sync(torch, device)
    t_pack = time.perf_counter() - t0
    scaling = torch.as_tensor(np.stack([gridgen.auto_scaling_factors(
        gt, lig.charges, lig.sigmas, lig.epsilons) for gt in GRID_TYPES]),
        dtype=torch.float32, device=device)
    binding = GridBinding(grid=multi, scaling=scaling)
    hermite, extra = None, {}
    if derivatives:
        t0 = time.perf_counter()
        hermite = GridBinding(grid=combine_hermite_packed(
            [pack_grid_hermite(g) for g in grids]), scaling=scaling)
        _sync(torch, device)
        extra = {"poly_basis": multi.poly_basis,
                 "hermite_pack_s": time.perf_counter() - t0,
                 "hermite_table_shape": list(hermite.grid.coeffs.shape),
                 "finite_grids": all(bool(torch.isfinite(g.derivs).all())
                                     for g in grids),
                 "finite_table": bool(torch.isfinite(multi.coeffs).all())}
    del grids
    system = system_from_amber(lig, dtype=torch.float32, hydrogen_mass=4.0,
                               device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    states = init_replica_states(
        gen, torch.as_tensor(lig_crd, dtype=torch.float32), system.masses,
        300.0, n_replicas, device=device)
    temps = torch.full((n_replicas,), 300.0, device=device)

    warm = make_md_runner(N_WARMUP, dt=0.001, friction=5.0, device=device)
    states = warm(states, system, [binding], temps)
    _sync(torch, device)
    run = make_md_runner(n_steps, dt=0.001, friction=5.0, device=device)
    t0 = time.perf_counter()
    states = run(states, system, [binding], temps)
    _sync(torch, device)
    t_seg = time.perf_counter() - t0
    launches = {"gridgen_values": values_kernel.launches,
                "gridgen_derivs": derivs_kernel.launches}
    # the same segment as eager launches, over a window from the final
    # states (the window's states are dropped)
    window = make_md_runner(EAGER_STEPS, dt=0.001, friction=5.0,
                            device=device)
    with graphs.eager():
        t0 = time.perf_counter()
        window(states, system, [binding], temps)
        _sync(torch, device)
        t_eager = time.perf_counter() - t0

    finite = bool(torch.isfinite(states.positions).all()
                  and torch.isfinite(states.velocities).all())
    t_rep = replica_temperatures(states, system.masses)
    emit({"phase": phase, "counts": counts,
          "grid_points": counts[0] * counts[1] * counts[2],
          "ligand_atoms": lig.natom, "receptor_atoms": rec.natom,
          "replicas": n_replicas, "interp_method": method.name,
          "launches": launches,
          "generate_s": t_gen, "pack_s": t_pack,
          "fused_table_shape": list(multi.coeffs.shape), **extra,
          "segment": "CUDA graph replays, blocks of 4 steps",
          "segment_steps": n_steps, "segment_s": t_seg,
          "steps_per_s": n_steps / t_seg,
          "replica_steps_per_s": n_steps * n_replicas / t_seg,
          "eager_window_steps": EAGER_STEPS,
          "eager_steps_per_s": EAGER_STEPS / t_eager,
          "graph_over_eager": (n_steps / t_seg) / (EAGER_STEPS / t_eager),
          "finite": finite, "median_T": float(t_rep.median()),
          "max_T": float(t_rep.max()),
          "replicas_above_600K": int((t_rep > 600.0).sum())})
    kernel = "gridgen_derivs" if derivatives else "gridgen_values"
    if torch.device(device).type == "cuda":
        check(launches[kernel] >= 3,
              f"{kernel} kernel launched {launches[kernel]} times")
    for key in ("finite_grids", "finite_table"):
        check(extra.get(key, True), f"{phase}: {key} is false")
    check(finite, "non-finite positions or velocities")
    check(100.0 < float(t_rep.median()) < 600.0,
          f"median replica temperature {float(t_rep.median())} K")
    check(float(t_rep.max()) < 20000.0,
          f"a replica reached {float(t_rep.max())} K")
    return system, binding, hermite, states, launches[kernel]


def phase_main_path(torch, seed, lig, lig_crd, rec, rec_crd, counts,
                    origin, n_replicas=N_REPLICAS, n_steps=N_STEPS,
                    device="cuda"):
    """The value path: value grids (K1), B-spline packs, the MD segment."""
    return _run_path(torch, "main_path", seed, lig, lig_crd, rec, rec_crd,
                     counts, origin, n_replicas, n_steps, device, False)


def phase_deriv_path(torch, seed, lig, lig_crd, rec, rec_crd, counts,
                     origin, n_replicas=N_REPLICAS, n_steps=N_STEPS,
                     device="cuda"):
    """The derivative path: triquintic grids (K2 and the chain rules),
    Chebyshev and Hermite-row packs, the MD segment on the Chebyshev
    table."""
    return _run_path(torch, "deriv_path", seed, lig, lig_crd, rec, rec_crd,
                     counts, origin, n_replicas, n_steps, device, True)


def phase_deriv_setup_times(torch, rec, rec_crd, counts, origin):
    """Where generation's time goes on the derivative path, for one grid
    (ljr): the kernel, then the per-point chain rules and scaling."""
    from openmmgridforce_tpu_torch.ops import gridgen
    from openmmgridforce_tpu_torch.ops.cuda_gridgen_derivs import (
        gridgen_derivs)

    spacing = (SPACING,) * 3
    atoms = gridgen.receptor_atoms("ljr", rec_crd, rec.charges, rec.sigmas,
                                   rec.epsilons, device="cuda")
    raw = gridgen_derivs(atoms, counts, spacing, origin, "ljr")

    def postprocess():
        return gridgen._postprocess_raw_derivs(
            raw, grid_cap=GRID_CAP, inv_power=0.0, inv_power_mode=0,
            spacing=spacing)

    # device time between CUDA events, after a warm-up call, 3 repeats
    t_kernel = _cuda_ms(torch, lambda: gridgen_derivs(
        atoms, counts, spacing, origin, "ljr"), 3) / 1e3
    t_post = _cuda_ms(torch, postprocess, 3) / 1e3
    post = postprocess()
    u = raw[..., 0] / GRID_CAP
    emit({"phase": "deriv_setup_times", "grid_type": "ljr",
          "kernel_s": t_kernel, "postprocess_s": t_post, "repeats": 3,
          "points_passed_through": int((u < 0.1).sum()),
          "points_capped": int(((u >= 0.1) & (u <= 20.0)).sum()),
          "points_saturated": int((u > 20.0).sum()),
          "max_abs_scaled_deriv": float(post.abs().max())})


def phase_eval_check(torch, lig, system, binding, states, device="cuda",
                     phase="eval_check"):
    """energy_and_forces in f32 on the card vs the same pack in f64 on
    the host, at poses from the final states. Returns the f32 energies
    and forces."""
    from openmmgridforce_tpu_torch.mm import (GridBinding, energy_and_forces,
                                              system_from_amber)

    poses = states.positions[:N_EVAL_POSES]
    e32, f32 = energy_and_forces(system, [binding], poses)
    _sync(torch, device)
    multi = binding.grid
    multi64 = dataclasses.replace(
        multi, coeffs=multi.coeffs.to("cpu", torch.float64),
        spacing=multi.spacing.to("cpu", torch.float64),
        origin=multi.origin.to("cpu", torch.float64))
    b64 = GridBinding(grid=multi64,
                      scaling=binding.scaling.to("cpu", torch.float64))
    sys64 = system_from_amber(lig, dtype=torch.float64, hydrogen_mass=4.0,
                              device="cpu")
    e64, f64 = energy_and_forces(sys64, [b64],
                                 poses.to("cpu", torch.float64))
    e_err = float((e32.cpu().double() - e64).abs().max())
    f_err = float((f32.cpu().double() - f64).abs().max())
    e_scale = float(e64.abs().max())
    f_scale = float(f64.abs().max())
    emit({"phase": phase, "poses": N_EVAL_POSES,
          "grid": type(multi).__name__, "max_abs_E": e_scale, "E_err": e_err,
          "E_rel": e_err / e_scale, "max_abs_F": f_scale, "F_err": f_err,
          "F_rel": f_err / f_scale})
    check(e_err < 1e-4 * e_scale, f"energy rel err {e_err / e_scale}")
    check(f_err < 1e-4 * f_scale, f"force rel err {f_err / f_scale}")
    return e32, f32


def phase_deriv_eval_check(torch, lig, system, binding, hermite, states,
                           device="cuda"):
    """The derivative path's two packed forms at the final poses: each in
    f32 on the card against f64 on the host, and the Chebyshev polynomial
    pack against the Hermite-row pack of the same grids."""
    e_c, f_c = phase_eval_check(torch, lig, system, binding, states, device,
                                phase="deriv_eval_check")
    e_h, f_h = phase_eval_check(torch, lig, system, hermite, states, device,
                                phase="deriv_eval_check")
    e_scale, f_scale = float(e_h.abs().max()), float(f_h.abs().max())
    e_err = float((e_c - e_h).abs().max())
    f_err = float((f_c - f_h).abs().max())
    emit({"phase": "deriv_eval_check", "poses": N_EVAL_POSES,
          "grid": "chebyshev pack vs Hermite rows, f32 on the card",
          "max_abs_E": e_scale, "E_err": e_err, "E_rel": e_err / e_scale,
          "max_abs_F": f_scale, "F_err": f_err, "F_rel": f_err / f_scale})
    check(e_err < 1e-4 * e_scale, f"forms differ in energy by "
          f"{e_err / e_scale}")
    check(f_err < 1e-4 * f_scale, f"forms differ in force by "
          f"{f_err / f_scale}")


def _profile(torch, fn, host_ops=True):
    """torch.profiler over one call of ``fn`` (which must end in a
    synchronise): (wall us, device busy us, device operations, us by
    kernel name). ``host_ops`` False records the card's activity only,
    which keeps a window of hundreds of thousands of launches cheap."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host_ops:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, n_kernels, busy_us = {}, 0, 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        n_kernels += 1
        busy_us += us
        by_name[ev.name] = by_name.get(ev.name, 0.0) + us
    return wall_us, busy_us, n_kernels, by_name


def _window_profile(torch, fn, n_steps):
    """Per-step figures of a profiled window (``fn`` ends in a
    synchronise)."""
    fn()                                                  # warm-up
    wall_us, busy_us, n_kernels, by_name = _profile(torch, fn)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"profiled_wall_ms_per_step": wall_us / n_steps / 1e3,
            "device_ms_per_step": (busy_us / n_steps / 1e3
                                   if n_kernels else "not measured"),
            "device_busy_share": (busy_us / wall_us if n_kernels
                                  else "not measured"),
            "device_ops_per_step": n_kernels / n_steps,
            "top_device_ms_per_step": {name[:80]: us / n_steps / 1e3
                                       for name, us in top}}


def phase_step_profile(torch, system, binding, states, n_steps=20,
                       phase="step_profile"):
    """Where an MD step's time goes, as graph replays and as eager
    launches: torch.profiler over a short window of a path's runner,
    kernels summed by name."""
    from openmmgridforce_tpu_torch.mm import graphs, make_md_runner

    run = make_md_runner(n_steps, dt=0.001, friction=5.0, device="cuda")
    temps = torch.full((states.positions.shape[0],), 300.0, device="cuda")

    def window():
        run(states, system, [binding], temps)
        torch.cuda.synchronize()

    graph = _window_profile(torch, window, n_steps)
    with graphs.eager():
        eager = _window_profile(torch, window, n_steps)
    emit({"phase": phase, "steps": n_steps, "graph": graph, "eager": eager})


def _max_delta(torch, a, b):
    return (float((a.positions - b.positions).abs().max()),
            float((a.velocities - b.velocities).abs().max()))


def phase_segment_graph_check(torch, path, system, binding, states, n_steps,
                              dt, temperatures, seed=0):
    """The recorded segment against the same segment as eager launches,
    from the same states under the same explicit noise: max |dx| and
    max |dv|, gated at GRAPH_GATE. Returns (dx, dv)."""
    from openmmgridforce_tpu_torch.mm import MDState, graphs, make_md_runner

    x = states.positions
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    noise = torch.randn((n_steps,) + tuple(x.shape), generator=gen,
                        dtype=x.dtype, device=x.device)
    run = make_md_runner(n_steps, dt=dt, friction=5.0, device=x.device)
    start = MDState(x.clone(), states.velocities.clone(), None)
    graph = run(start, system, [binding], temperatures, noise=noise)
    with graphs.eager():
        eager = run(start, system, [binding], temperatures, noise=noise)
    torch.cuda.synchronize()
    dx, dv = _max_delta(torch, graph, eager)
    emit({"phase": "segment_graph_check", "path": path,
          "replicas": int(x.shape[0]), "steps": n_steps,
          "constrained": system.constraints is not None, "max_abs_dx_nm": dx,
          "max_abs_dv_nm_per_ps": dv, "bitwise_equal": dx == 0 and dv == 0,
          "gate": GRAPH_GATE})
    check(torch.isfinite(graph.positions).all(), f"{path}: non-finite graph "
          "segment")
    check(dx <= GRAPH_GATE and dv <= GRAPH_GATE,
          f"{path}: graph and eager segments differ by {dx} nm, {dv} nm/ps")
    return dx, dv


def phase_capture_failure():
    """A step that synchronises with the host cannot be recorded: the
    segment must raise (in a child process, which PyTorch may abort when
    it destroys the failed graph)."""
    root = os.path.dirname(os.path.abspath(__file__))
    code = ("import torch\n"
            "from openmmgridforce_tpu_torch.mm import graphs\n"
            "x = torch.ones(3, device='cuda')\n"
            "seg = graphs.Segment(lambda c, n: (c[0] * float(c[0].sum()),),"
            " (x,))\n"
            "try:\n"
            "    seg.run((x,), 8)\n"
            "except Exception as e:\n"
            "    print('raised', type(e).__name__, flush=True)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=root,
                          env={**os.environ, "PYTHONPATH": root})
    raised = proc.stdout.split()[1] if "raised" in proc.stdout else None
    emit({"phase": "segment_graph_check", "path": "capture_failure",
          "raised": raised, "child_exit": proc.returncode})
    check(raised is not None, "a failed capture did not raise: "
          + (proc.stdout + proc.stderr)[-400:])


def phase_bpmf_path(torch, seed, lig, lig_crd, rec, rec_crd, counts,
                    origin, n_states=BPMF_STATES,
                    equil_steps=BPMF_EQUIL_STEPS, n_trials=BPMF_TRIALS,
                    nstep_md=BPMF_NSTEP_MD, device="cuda"):
    """The BPMF sampler path (examples/bpmf_sampler_torch.py's route):
    value grids through the values kernel, B-spline packs fused slab by
    slab, an HBonds-constrained system with hydrogen mass 4, a geometric
    300-600 K ladder at dt 2 fs; equilibration in drain rounds, then
    trials of exchange sweeps, genetic-MC sweeps and MD segments, the last
    one timed beside its MD's device time. Returns the values kernel's
    launches on this path."""
    from openmmgridforce_tpu_torch.grid import InterpolationMethod
    from openmmgridforce_tpu_torch.mm import GridBinding, system_from_amber
    from openmmgridforce_tpu_torch.mm.constraints import (apply_rattle,
                                                          apply_shake)
    from openmmgridforce_tpu_torch.ops import gridgen
    from openmmgridforce_tpu_torch.ops.packed import pack_grids_fused
    from openmmgridforce_tpu_torch.parallel import replica_temperatures
    from openmmgridforce_tpu_torch.sampling import Sampler, SamplerConfig

    spacing = (SPACING,) * 3
    values_kernel, derivs_kernel = _reset_launches()
    apply_shake.stats.reset()
    apply_rattle.stats.reset()
    _sync(torch, device)
    t0 = time.perf_counter()
    grids = [gridgen.generate_grid(
        counts, spacing, origin, gt, rec_crd, rec.charges, rec.sigmas,
        rec.epsilons, grid_cap=GRID_CAP,
        interp_method=InterpolationMethod.BSPLINE, device=device)
        for gt in GRID_TYPES]
    _sync(torch, device)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    multi = pack_grids_fused(grids, x_chunk=BPMF_X_CHUNK, device=device)
    _sync(torch, device)
    t_pack = time.perf_counter() - t0
    del grids
    scaling = torch.as_tensor(np.stack([gridgen.auto_scaling_factors(
        gt, lig.charges, lig.sigmas, lig.epsilons) for gt in GRID_TYPES]),
        dtype=torch.float32, device=device)
    system = system_from_amber(lig, dtype=torch.float32,
                               hydrogen_mass=BPMF_H_MASS,
                               constraints="HBonds", device=device)
    config = SamplerConfig(n_states=n_states, t_high=BPMF_T_HIGH,
                           t_min=BPMF_T_MIN, dt=BPMF_DT,
                           friction=BPMF_FRICTION,
                           md_steps_per_trial=nstep_md,
                           hydrogen_mass=BPMF_H_MASS, seed=seed)
    sampler = Sampler(system, [GridBinding(grid=multi, scaling=scaling)],
                      lig_crd, config,
                      bonds=[tuple(b) for b in lig.bond_idx], device=device)

    t0 = time.perf_counter()
    redrawn = []
    for _ in range(BPMF_DRAIN_ROUNDS):
        sampler.run_md(equil_steps // BPMF_DRAIN_ROUNDS)
        redrawn.append(sampler.drain_trapped())
    _sync(torch, device)
    t_equil = time.perf_counter() - t0

    t0 = time.perf_counter()
    sampler.run(n_trials - 1, n_exchange_per_trial=BPMF_REPX,
                n_gmc_per_trial=BPMF_GMC)
    _sync(torch, device)
    t_trials = time.perf_counter() - t0

    def last_trial():
        sampler.run(1, n_exchange_per_trial=BPMF_REPX,
                    n_gmc_per_trial=BPMF_GMC)
        _sync(torch, device)

    t0 = time.perf_counter()
    last_trial()
    wall_s = time.perf_counter() - t0
    sweeps = (apply_shake.stats.summary(), apply_rattle.stats.summary())
    timed = {"wall_s": wall_s}
    if torch.device(device).type == "cuda":
        # the trial's MD as device time: its block replayed back to back
        # (the profiler does not trace the WHILE bodies of the recording)
        from openmmgridforce_tpu_torch.mm.system import _md_segment

        seg = _md_segment(sampler.system, sampler.grids, sampler.states,
                          config.dt, config.friction, "classic",
                          True).segment
        ms = _replay_ms_per_step(torch, seg)
        timed.update({"md_device_ms_per_step": ms,
                      "md_device_share_of_trial": (ms * nstep_md / 1e3
                                                   / wall_s)})
    launches = {"gridgen_values": values_kernel.launches,
                "gridgen_derivs": derivs_kernel.launches}

    states = sampler.states
    x = states.positions
    cs = system.constraints
    d = x[:, cs.idx[:, 0]] - x[:, cs.idx[:, 1]]
    violation = float((d.norm(dim=-1) / cs.length - 1.0).abs().max())
    rec_x = torch.as_tensor(rec_crd, dtype=x.dtype, device=x.device)
    contact = float(torch.cdist(x.reshape(-1, 3), rec_x).min())
    t_inst = replica_temperatures(states, system.masses).double().cpu()
    ratio = t_inst / torch.as_tensor(sampler.temperatures)
    finite = bool(torch.isfinite(x).all()
                  and torch.isfinite(states.velocities).all())
    steps_timed = (n_trials - 1) * nstep_md * n_states
    emit({"phase": "bpmf_path", "counts": counts,
          "grid_points": counts[0] * counts[1] * counts[2],
          "ligand_atoms": lig.natom, "receptor_atoms": rec.natom,
          "receptor_gap_nm": BPMF_RECEPTOR_GAP, "states": n_states,
          "ladder_K": [BPMF_T_MIN, BPMF_T_HIGH],
          "constraints": cs.num_constraints, "dt_ps": BPMF_DT,
          "friction": BPMF_FRICTION, "hydrogen_mass": BPMF_H_MASS,
          "nstep_md": nstep_md, "ntrial_repX": BPMF_REPX,
          "ntrial_gMC": BPMF_GMC,
          "cuts": {"equilibration_steps": [equil_steps,
                                           BPMF_EQUIL_REFERENCE],
                   "drain_rounds": BPMF_DRAIN_ROUNDS,
                   "trials": [n_trials, BPMF_TRIALS_REFERENCE]},
          "launches": launches, "generate_s": t_gen, "pack_s": t_pack,
          "fused_table_shape": list(multi.coeffs.shape),
          "x_chunk": BPMF_X_CHUNK, "equilibration_s": t_equil,
          "redrawn_per_round": redrawn,
          "equilibration_replica_steps_per_s":
              equil_steps * n_states / t_equil,
          "trials_timed": n_trials - 1, "trials_s": t_trials,
          "replica_steps_per_s": steps_timed / t_trials,
          "shake_sweeps_per_step": sweeps[0],
          "rattle_sweeps_per_step": sweeps[1],
          "exchange_accepted": [sampler.n_exchange_accepted,
                                sampler.n_exchange_attempted],
          "gmc_accepted": [sampler.n_gmc_accepted, sampler.n_gmc_attempted],
          "T_inst_K": [round(float(t), 1) for t in t_inst],
          "median_T_over_rung": float(ratio.median()),
          "max_T_K": float(t_inst.max()),
          "max_rel_constraint_violation": violation,
          "min_ligand_receptor_nm": contact,
          "timed_trial": timed, "finite": finite})
    if torch.device(device).type == "cuda":
        check(launches["gridgen_values"] >= 3,
              f"gridgen_values launched {launches['gridgen_values']} times "
              "on bpmf_path")
    check(finite, "bpmf_path: non-finite positions or velocities")
    check(violation < 1e-4, f"bpmf_path: a constrained distance is "
          f"{violation} from its length")
    check(0.5 < float(ratio.median()) < 2.0,
          f"bpmf_path: median T_inst / T_rung {float(ratio.median())}")
    check(float(t_inst.max()) < 20000.0,
          f"bpmf_path: a rung reached {float(t_inst.max())} K")
    check(sampler.n_exchange_accepted >= 1, "bpmf_path: no exchange "
          f"accepted in {sampler.n_exchange_attempted}")
    if torch.device(device).type == "cuda":
        phase_bpmf_segments(torch, sampler, nstep_md)
    return launches["gridgen_values"]


def _atomic_plan(index, n_atoms, keys, coef=None, src_rows=None,
                 dtype=None):
    """A row sum through ``index_add_`` on the card too (its atomics add
    in no fixed order): what the fixed-order sums are timed against."""
    from openmmgridforce_tpu_torch.ops.scatter import RowSum

    return RowSum(index, coef, n_atoms,
                  len(index) if src_rows is None else int(src_rows),
                  None, None)


def _api_grid_force(gfp, counts, origin, grid_data=None):
    f = gfp.GridForce(grid_data)
    f.addGridCounts(*counts)
    f.addGridSpacing(SPACING, SPACING, SPACING)
    f.setGridOrigin(*origin)
    return f


def _api_compare(ctx, host):
    """getState of a Context on the card against a host Context on the
    same forces: (relative energy error, force error over max|F|)."""
    got = ctx.getState(getEnergy=True, getForces=True)
    want = host.getState(getEnergy=True, getForces=True)
    e = abs(got.getPotentialEnergy() - want.getPotentialEnergy()) / abs(
        want.getPotentialEnergy())
    f = float(np.abs(got.getForces() - want.getForces()).max()
              / np.abs(want.getForces()).max())
    return e, f


def phase_api_path(torch, seed, smi, lig, lig_crd, rec, rec_crd, counts,
                   origin, device="cuda"):
    """The compat API (openmmgridforce_tpu_torch.api), the README's
    workflow at full width: grids auto-generated through Contexts on the
    receptor system (float64 values through K1, float64 derivatives
    through K2, and a tiled OMGTILE file through float32 K1 slabs), then
    the ligand system (hydrogen mass 4, HBonds) on the card: getState
    against a host Context on the same forces (B-spline and triquintic),
    Langevin steps as graph replays and as eager launches, recorded
    against eager under explicit noise, Simulation.minimizeEnergy, and a
    streamed Context on the tiled files against the in-memory one.
    Returns the launches of each kernel instantiation on this path.
    ``device="cpu"`` rehearses the phase at a small size on the host (no
    kernels, recordings or kernel timings there)."""
    import openmmgridforce_tpu_torch.api as gfp
    from openmmgridforce_tpu_torch.mm import graphs
    from openmmgridforce_tpu_torch.units import BOLTZ

    timings = {}

    def timing(metric, value):
        timings[metric] = value
        emit({"phase": "api_path_timing", "metric": metric, "value": value,
              "card": smi})

    values_kernel, derivs_kernel = _reset_launches()
    on_card = torch.device(device).type == "cuda"
    start_gb = torch.cuda.memory_allocated() / 1e9 if on_card else None
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_tiles_",
                               dir=os.path.dirname(os.path.abspath(
                                   __file__)))
    try:
        # --- grids through Contexts on the receptor system -------------
        _sync(torch, device)
        t0 = time.perf_counter()
        rec_system = gfp.create_system(rec, device=device)
        _sync(torch, device)
        timing("receptor_system_s", time.perf_counter() - t0)
        stages = {"values": {}, "derivatives": {}, "tiled": {}}
        data = {k: [gfp.GridData(*counts, *(SPACING,) * 3)
                    for _ in GRID_TYPES] for k in ("values", "derivatives")}
        for k in data:
            for gd in data[k]:
                gd.setOrigin(*origin)
        for stage, launches in stages.items():
            for gt, gd in zip(GRID_TYPES, data.get(stage, (None,) * 3)):
                f = _api_grid_force(gfp, counts, origin, gd)
                f.setAutoGenerateGrid(True)
                f.setGridType(gt)
                f.setGridCap(GRID_CAP)
                f.setReceptorPositions(rec_crd)
                f.setScalingFactors(np.zeros(rec.natom))
                f.setComputeDerivatives(stage == "derivatives")
                if stage == "tiled":
                    f.setTiledOutputFile(os.path.join(workdir,
                                                      f"{gt}.tiled"),
                                         TILE_SIZE)
                rec_system.addForce(f)
            before = (values_kernel.launches, derivs_kernel.launches)
            _sync(torch, device)
            t0 = time.perf_counter()
            gfp.Context(rec_system, gfp.VerletIntegrator(0.001),
                        device=device)
            _sync(torch, device)
            timing(f"context_setup_{stage}_s", time.perf_counter() - t0)
            launches.update(gridgen_values=values_kernel.launches
                            - before[0],
                            gridgen_derivs=derivs_kernel.launches
                            - before[1])
        tiled = [f.getTiledInputFile() for f in rec_system.getForces()[-3:]]
        del rec_system
        if on_card:
            torch.cuda.empty_cache()
        # what the receptor system and its Contexts leave on the card: no
        # reference cycle holds them for a garbage collection
        left_gb = torch.cuda.memory_allocated() / 1e9 if on_card else None

        # --- the ligand on the card against the host ---------------------
        scal_props = dict(zip(GRID_TYPES, GRID_TYPES))

        def ligand_system(grid_datas, method, device=device,
                          constraints="HBonds", files=None):
            system = gfp.create_system(lig, hydrogen_mass=BPMF_H_MASS,
                                       constraints=constraints,
                                       device=device)
            for i, gt in enumerate(GRID_TYPES):
                if files is None:
                    f = gfp.GridForce(grid_datas[i])
                else:
                    f = _api_grid_force(gfp, counts, origin)
                    f.setTiledInputFile(files[i])
                f.setInterpolationMethod(method)
                f.setScalingProperty(scal_props[gt])
                f.setAutoCalculateScalingFactors(True)
                system.addForce(f)
            return system

        def ligand(grid_datas, method, device=device, constraints="HBonds",
                   integrator=None, files=None):
            ctx = gfp.Context(ligand_system(grid_datas, method, device,
                                            constraints, files),
                              integrator or gfp.VerletIntegrator(0.001),
                              device=device)
            ctx.setPositions(lig_crd)
            return ctx

        _sync(torch, device)
        t0 = time.perf_counter()
        ctx = ligand(data["values"], 1, integrator=gfp.LangevinIntegrator(
            300.0, 1.0, BPMF_DT))
        _sync(torch, device)
        timing("ligand_context_setup_s", time.perf_counter() - t0)
        errors = {"bspline": _api_compare(ctx, ligand(data["values"], 1,
                                                      device="cpu"))}
        hermite = ligand(data["derivatives"], 3)
        errors["triquintic"] = _api_compare(
            hermite, ligand(data["derivatives"], 3, device="cpu"))
        del hermite
        timing("getstate_ms", 1e3 * _host_seconds(
            lambda: ctx.getState(getEnergy=True, getForces=True), 5))

        # --- Langevin: graph replays, eager launches, recorded == eager ---
        ctx.setVelocitiesToTemperature(300.0, seed=seed)
        integ = ctx.getIntegrator()
        integ.step(API_CHUNK)                          # records the blocks
        masses = ctx._core.masses[:, None]
        cs = ctx._core.constraints
        dof = 3 * lig.natom - cs.num_constraints
        kinetic = []
        _sync(torch, device)
        t0 = time.perf_counter()
        for _ in range(API_STEPS // API_CHUNK):
            integ.step(API_CHUNK)
            kinetic.append(0.5 * (masses * ctx._velocities ** 2).sum())
        _sync(torch, device)
        graph_s = time.perf_counter() - t0
        timing("steps_per_s_graph", API_STEPS / graph_s)
        t_inst = (2.0 * torch.stack(kinetic) / (dof * BOLTZ)).cpu().numpy()
        x, v = ctx._positions, ctx._velocities
        d = x[cs.idx[:, 0]] - x[cs.idx[:, 1]]
        violation = float((d.norm(dim=-1) / cs.length - 1.0).abs().max())
        finite = bool(torch.isfinite(x).all() and torch.isfinite(v).all())
        with graphs.eager():
            _sync(torch, device)
            t0 = time.perf_counter()
            integ.step(EAGER_STEPS)
            _sync(torch, device)
        timing("steps_per_s_eager", EAGER_STEPS / (time.perf_counter() - t0))
        if on_card:
            timing("step_device_ms_graph", _replay_ms_per_step(
                torch, ctx._segment))
            timing("eval_ms", _cuda_ms(torch, lambda: ctx._terms.terms(x),
                                       20))
        # what an eager evaluation launches: ATen calls on the host (a
        # host-only profile: recordings with WHILE nodes are alive)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            ctx._terms.terms(x)
        timing("eval_aten_calls", sum(
            1 for ev in prof.events() if ev.name.startswith("aten::")))
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        noise = torch.randn((GRAPH_CHECK_CONSTRAINED_STEPS,)
                            + tuple(x.shape), generator=gen,
                            dtype=x.dtype, device=x.device)
        start = (ctx._positions.clone(), ctx._velocities.clone())
        ends = []
        for eager in (False, True):
            ctx._positions, ctx._velocities = (t.clone() for t in start)
            with graphs.eager() if eager else contextlib.nullcontext():
                ctx._step(len(noise), noise=noise)
            ends.append((ctx._positions, ctx._velocities))
        dx = float((ends[0][0] - ends[1][0]).abs().max())
        dv = float((ends[0][1] - ends[1][1]).abs().max())
        del ctx

        # --- minimisation from a perturbed pose ---------------------------
        rng = np.random.default_rng(seed)
        sim = gfp.Simulation(lig, ligand_system(data["values"], 1,
                                                constraints=None),
                             gfp.VerletIntegrator(0.001), device=device)
        sim.context.setPositions(lig_crd + rng.normal(0.0, 0.004,
                                                      lig_crd.shape))
        e0 = sim.context.getState(getEnergy=True).getPotentialEnergy()
        _sync(torch, device)
        t0 = time.perf_counter()
        sim.minimizeEnergy(maxIterations=API_MIN_ITERATIONS,
                           tolerance=API_MIN_TOLERANCE)
        _sync(torch, device)
        min_s = time.perf_counter() - t0
        timing("minimizer_s", min_s)
        timing("minimizer_s_per_iteration",
               min_s / max(sim.minimizer_iterations, 1))
        st = sim.context.getState(getEnergy=True, getForces=True)
        e1 = st.getPotentialEnergy()
        rms = float(np.sqrt((st.getForces() ** 2).mean()))

        # --- streamed Context on the tiled files -------------------------
        streamed = ligand(None, 1, constraints=None, files=tiled)
        memory = ligand(data["values"], 1, constraints=None)
        streamed.getIntegrator().step(API_CHUNK)
        _sync(torch, device)
        t0 = time.perf_counter()
        streamed.getIntegrator().step(API_STREAM_STEPS)
        _sync(torch, device)
        timing("streamed_steps_per_s",
               API_STREAM_STEPS / (time.perf_counter() - t0))
        memory.setPositions(streamed.getPositions())
        e_stream = streamed.getState(getEnergy=True).getPotentialEnergy()
        e_memory = memory.getState(getEnergy=True).getPotentialEnergy()
        stream_err = abs(e_stream - e_memory) / max(abs(e_stream),
                                                    abs(e_memory))
        stream_finite = bool(np.isfinite(streamed.getPositions()).all())
        del streamed, memory

        # --- the path's kernel launches, timed at its shapes -------------
        launches = {
            "gridgen_values_f64": stages["values"]["gridgen_values"],
            "gridgen_derivs_f64": stages["derivatives"]["gridgen_derivs"],
            "gridgen_values": stages["tiled"]["gridgen_values"]}
        from openmmgridforce_tpu_torch.ops.gridgen import receptor_atoms
        for gt in GRID_TYPES if on_card else ():
            atoms = receptor_atoms(gt, rec_crd, rec.charges, rec.sigmas,
                                   rec.epsilons, dtype=torch.float64,
                                   device="cuda")
            geom = (atoms, counts, (SPACING,) * 3, origin, gt)
            timing(f"kernel_gridgen_values_f64_{gt}_ms", _cuda_ms(
                torch, lambda: values_kernel(*geom, GRID_CAP), 3))
            timing(f"kernel_gridgen_derivs_f64_{gt}_ms", _cuda_ms(
                torch, lambda: derivs_kernel(*geom), 1))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    last = t_inst[-(API_STEPS // 2) // API_CHUNK:]
    emit({"phase": "api_path", "counts": counts,
          "grid_points": counts[0] * counts[1] * counts[2],
          "ligand_atoms": lig.natom, "receptor_atoms": rec.natom,
          "receptor_gap_nm": BPMF_RECEPTOR_GAP, "dtype": "float64",
          "launches": launches, "launches_by_stage": stages,
          "getstate_rel_err": {k: {"energy": e, "forces": f}
                               for k, (e, f) in errors.items()},
          "steps": API_STEPS, "dt_ps": BPMF_DT, "friction": 1.0,
          "constraints": cs.num_constraints, "dof": dof,
          "T_inst_sampled_every": API_CHUNK,
          "max_T_K": float(t_inst.max()),
          "mean_T_over_300_last_half": float(last.mean() / 300.0),
          "max_rel_constraint_violation": violation, "finite": finite,
          "graph_vs_eager": {"steps": len(noise), "max_abs_dx_nm": dx,
                             "max_abs_dv_nm_per_ps": dv},
          "minimizer": {"e0": e0, "e1": e1, "rms": rms,
                        "iterations": sim.minimizer_iterations,
                        "max_iterations": API_MIN_ITERATIONS,
                        "tolerance": API_MIN_TOLERANCE},
          "streamed": {"steps": API_STREAM_STEPS, "energy": e_stream,
                       "in_memory_energy": e_memory,
                       "rel_err": stream_err, "finite": stream_finite},
          "allocated_gb_at_start": start_gb,
          "allocated_gb_after_receptor_system": left_gb,
          "timings": timings, "card": smi})
    if on_card:
        check(launches["gridgen_values_f64"] == 3
              and launches["gridgen_derivs_f64"] == 3
              and launches["gridgen_values"] > 0
              and stages["values"]["gridgen_derivs"] == 0
              and stages["derivatives"]["gridgen_values"] == 0,
              f"api_path launched {stages}")
    for k, (e, f) in errors.items():
        check(e < 1e-10 and f < 1e-9, f"api_path {k}: card vs host energy "
              f"{e}, forces {f}")
    check(finite, "api_path: non-finite positions or velocities")
    check(violation < 1e-4, f"api_path: a constrained distance is "
          f"{violation} from its length")
    check(float(t_inst.max()) < 20000.0,
          f"api_path: T_inst reached {float(t_inst.max())} K")
    check(0.5 < float(last.mean() / 300.0) < 2.0,
          f"api_path: mean T_inst / T {float(last.mean() / 300.0)}")
    check(dx <= 1e-12 and dv <= 1e-12, f"api_path: recorded and eager "
          f"steps differ by {dx} nm, {dv} nm/ps")
    check(e1 < e0 and rms < 100.0, f"api_path: minimisation {e0} -> {e1}, "
          f"rms {rms}")
    check(stream_finite and stream_err < 1e-4, "api_path: streamed energy "
          f"{e_stream} against in-memory {e_memory}")
    return launches


def _replay_ms_per_step(torch, seg, reps=BPMF_REPLAYS):
    """Device time a step of a recorded segment: its block graph replayed
    ``reps`` times back to back, timed with CUDA events (the host launches
    a replay in microseconds, the card runs it in milliseconds). The
    profiler is not used: it does not trace the bodies of conditional
    nodes (PERF.md)."""
    from openmmgridforce_tpu_torch.mm import graphs

    graph = seg._blocks[graphs.BLOCK].graph
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * graphs.BLOCK)


def phase_bpmf_segments(torch, sampler, nstep_md):
    """The sampler's MD segment as graph replays (the constraint sweeps
    stopped by a WHILE node), the same recorded with the bonded and
    constraint row sums through ``index_add_``'s atomics instead of the
    fixed-order sums, and as eager launches (per-block graphs of sweeps
    with a host check): rates, sweep counts, device ms a step (recordings:
    back-to-back replays; eager: the profiler); then the constrained ladder
    through segment_graph_check."""
    import contextlib
    import unittest.mock

    from openmmgridforce_tpu_torch.mm import constraints, forcefield, graphs
    from openmmgridforce_tpu_torch.mm.constraints import (apply_rattle,
                                                          apply_shake)
    from openmmgridforce_tpu_torch.mm.system import _md_segment

    system = sampler.system
    n_states = sampler.states.positions.shape[0]
    out = {}
    for mode in ("graph", "graph_index_add", "eager"):
        ctx = contextlib.ExitStack()
        if mode == "eager":
            ctx.enter_context(graphs.eager())
        if mode == "graph_index_add":
            # a system of its own, so that its recording is its own
            sampler.system = dataclasses.replace(system)
            for mod in (constraints, forcefield):
                ctx.enter_context(unittest.mock.patch.object(
                    mod, "row_sum_plan", _atomic_plan))
        with ctx:
            sampler.run_md(nstep_md)          # records the segment, untimed
            torch.cuda.synchronize()
            apply_shake.stats.reset()
            apply_rattle.stats.reset()
            t0 = time.perf_counter()
            for _ in range(BPMF_CANDIDATE_SEGMENTS):
                sampler.run_md(nstep_md)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            row = {"replica_steps_per_s": (BPMF_CANDIDATE_SEGMENTS * nstep_md
                                           * n_states / seconds),
                   "sweeps_per_call": {"shake": apply_shake.stats.summary(),
                                       "rattle": apply_rattle.stats.summary()}}
            wall_ms = seconds * 1e3 / (BPMF_CANDIDATE_SEGMENTS * nstep_md)
            if mode == "eager":
                def segment():
                    sampler.run_md(nstep_md)
                    torch.cuda.synchronize()

                wall_us, busy_us, n_ops, _ = _profile(torch, segment,
                                                      host_ops=False)
                row.update({
                    "device_ops_per_step": n_ops / nstep_md,
                    "device_ms_per_step": (busy_us / nstep_md / 1e3
                                           if n_ops else "not measured"),
                    "device_busy_share": (busy_us / wall_us if n_ops
                                          else "not measured")})
            else:
                seg = _md_segment(sampler.system, sampler.grids,
                                  sampler.states, sampler.config.dt,
                                  sampler.config.friction, "classic",
                                  True).segment
                ms = _replay_ms_per_step(torch, seg)
                row.update({"device_ms_per_step_replays": ms,
                            "wall_ms_per_step": wall_ms,
                            "device_share_of_wall": ms / wall_ms,
                            "device_ops_per_step": "not measured: the "
                            "profiler does not trace WHILE bodies"})
        out[mode] = row
        sampler.system = system
    emit({"phase": "bpmf_segments", "steps": nstep_md,
          "segments_timed": BPMF_CANDIDATE_SEGMENTS, "states": n_states,
          "replays_timed": BPMF_REPLAYS, **out})
    phase_segment_graph_check(
        torch, "bpmf_path", system, sampler.grids[0], sampler.states,
        GRAPH_CHECK_CONSTRAINED_STEPS, BPMF_DT, sampler._temps)


# ----------------------------------------------------------------------
# The accuracy tier and the alternate semantics on the card
# ----------------------------------------------------------------------

def _rel(got, want):
    return float(((got - want).abs() / want.abs().clamp_min(1e-300)).max())


def phase_twofloat_check(torch, seed):
    """The error-free transforms and double-word operations of
    ops/twofloat.py on the card, on TWOFLOAT_N values: 2Sum exact, 2Prod,
    df_mul, df_add and df_sum within 1e-13 relative of float64 on the
    host (a multiply and add contracted into an FMA would show here)."""
    from openmmgridforce_tpu_torch.ops import twofloat as tf

    rng = np.random.default_rng(seed + 7)
    n = TWOFLOAT_N

    def pair(x64):
        hi, lo = tf.df_from_f64(x64)
        return (torch.from_numpy(hi).cuda(), torch.from_numpy(lo).cuda())

    def host(p):
        return p[0].double().cpu() + p[1].double().cpu()

    a = (rng.standard_normal(n) * 1e6).astype(np.float32)
    b = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    a64 = torch.from_numpy(a).double()
    b64 = torch.from_numpy(b).double()
    s = tf.two_sum(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda())
    sum_exact = bool(torch.equal(host(s), a64 + b64))
    p = tf.two_prod(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda())
    prod_rel = _rel(host(p), a64 * b64)
    x64 = rng.standard_normal(n) * 1e5
    y64 = rng.standard_normal(n)
    x, y = pair(x64), pair(y64)
    tx, ty = torch.from_numpy(x64), torch.from_numpy(y64)
    mul_rel = _rel(host(tf.df_mul(x, y)), tx * ty)
    add_rel = float(((host(tf.df_add(x, y)) - (tx + ty)).abs()
                     / (tx.abs() + ty.abs())).max())
    z64 = rng.standard_normal(n) * 1e6 + rng.standard_normal(n) * 1e-3
    tot = tf.df_sum(pair(z64))
    sum_rel = abs(float(host((tot[0][None], tot[1][None]))[0])
                  - float(np.sum(z64))) / float(np.abs(z64).sum())
    torch.cuda.synchronize()
    emit({"phase": "twofloat_check", "values": n, "two_sum_exact": sum_exact,
          "two_prod_max_rel": prod_rel, "df_mul_max_rel": mul_rel,
          "df_add_max_rel": add_rel, "df_sum_rel": sum_rel, "gate": 1e-13})
    check(sum_exact, "two_sum is not exact on the card")
    for name, v in (("two_prod", prod_rel), ("df_mul", mul_rel),
                    ("df_add", add_rel), ("df_sum", sum_rel)):
        check(v <= 1e-13, f"{name} is {v} from float64 on the card")


def phase_semantics_check(torch, seed, lig, lig_crd, rec, rec_crd, counts,
                          origin):
    """The alternate semantics and the compensated tier on the card against
    float64 on the host. The common and reference semantics run float64 on
    the card on a small grid with atoms inside, outside and on the faces
    (1e-12 of the host's energies, forces 1e-10: the JAX tests'
    tolerances); evaluate_compensated runs on the bench box's K1 grids
    (float32, packed in float64 on the host) against the float64
    evaluation of the same stored values on the host, at poses around the
    ligand (COMPENSATED_GATE of max|E| per atom and of max|F|), with plain
    float32 packs beside it."""
    from openmmgridforce_tpu_torch import convert
    from openmmgridforce_tpu_torch.grid import InterpolationMethod
    from openmmgridforce_tpu_torch.ops import gridgen
    from openmmgridforce_tpu_torch.ops.common_semantics import (
        evaluate_grid_common)
    from openmmgridforce_tpu_torch.ops.compensated import (
        evaluate_compensated, pack_grid_compensated)
    from openmmgridforce_tpu_torch.ops.interpolate import evaluate_grid
    from openmmgridforce_tpu_torch.ops.packed import evaluate_packed, pack_grid
    from openmmgridforce_tpu_torch.ops.reference_semantics import (
        evaluate_grid_reference)

    rng = np.random.default_rng(seed + 11)
    small = (9, 8, 7)
    spacing, org = (0.11, 0.09, 0.13), (0.2, -0.1, 0.05)
    lo = np.asarray(org)
    hi = lo + (np.asarray(small) - 1) * np.asarray(spacing)
    pos = rng.uniform(lo - 0.05, hi + 0.05, (64, 3))
    pos[0], pos[1] = hi, lo
    scal = rng.uniform(-1.0, 1.0, len(pos))
    scal[5] = 0.0
    derivs = rng.standard_normal(small + (27,))
    derivs[..., 0] = rng.standard_normal(small) + 2.5
    cases = {}
    for name, fn, method, inv in (
            ("common_trilinear", evaluate_grid_common, 0, 0.0),
            ("common_bspline_pow2", evaluate_grid_common, 1, 2.0),
            ("reference_trilinear", evaluate_grid_reference, 0, 0.0),
            ("reference_bspline_pow2", evaluate_grid_reference, 1, 2.0),
            ("reference_tricubic_fd", evaluate_grid_reference, 2, 0.0),
            ("reference_triquintic", evaluate_grid_reference, 3, 0.0)):
        out = {}
        for dev in ("cpu", "cuda"):
            g = convert.grid_from_arrays(
                derivs[..., 0], spacing, org, derivs=derivs,
                interp_method=method, inv_power=inv,
                inv_power_mode=2 if inv else 0, oob_k=10000.0,
                dtype=torch.float64, device=dev)
            out[dev] = fn(g, torch.as_tensor(pos, device=dev), scal)
        e_ref = out["cpu"].per_atom_energy
        f_ref = out["cpu"].forces
        e_err = float((out["cuda"].per_atom_energy.cpu() - e_ref).abs()
                      .max() / e_ref.abs().max())
        f_err = float(((out["cuda"].forces.cpu() - f_ref).abs()
                       - 1e-10 * f_ref.abs()).max())
        cases[name] = {"E_rel": e_err, "F_excess_over_1e-10_rel": f_err}
        check(e_err <= 1e-12, f"semantics {name}: energies {e_err} off")
        check(f_err <= 1e-12, f"semantics {name}: forces {f_err} off")

    # the compensated tier on the bench box, float32 K1 grids
    poses = torch.as_tensor(
        lig_crd[None] + rng.normal(0.0, 0.05, (N_COMPENSATED_POSES, 1, 3))
        + rng.normal(0.0, 0.01, (N_COMPENSATED_POSES,) + lig_crd.shape),
        dtype=torch.float64)
    comp = {}
    for gt in GRID_TYPES:
        g32 = gridgen.generate_grid(
            counts, (SPACING,) * 3, origin, gt, rec_crd, rec.charges,
            rec.sigmas, rec.epsilons, grid_cap=GRID_CAP,
            interp_method=InterpolationMethod.BSPLINE, device="cuda")
        s = gridgen.auto_scaling_factors(gt, lig.charges, lig.sigmas,
                                         lig.epsilons)
        t0 = time.perf_counter()
        cp = pack_grid_compensated(g32, origin=origin, spacing=(SPACING,) * 3)
        torch.cuda.synchronize()
        t_pack = time.perf_counter() - t0
        g64 = g32.with_(vals=g32.vals.to("cpu", torch.float64),
                        spacing=torch.tensor((SPACING,) * 3,
                                             dtype=torch.float64),
                        origin=torch.tensor(origin, dtype=torch.float64))
        truth = evaluate_grid(g64, poses, s)
        got = evaluate_compensated(cp, poses.cuda(), s)
        plain = evaluate_packed(pack_grid(g32), poses.cuda().float(),
                                torch.as_tensor(s, dtype=torch.float32,
                                                device="cuda"))
        torch.cuda.synchronize()
        e_scale = float(truth.per_atom_energy.abs().max())
        f_scale = float(truth.forces.abs().max())

        def err(res, scale, field):
            return float((getattr(res, field).cpu().double()
                          - getattr(truth, field)).abs().max()) / scale

        comp[gt] = {"E_rel": err(got, e_scale, "per_atom_energy"),
                    "F_rel": err(got, f_scale, "forces"),
                    "plain_f32_E_rel": err(plain, e_scale,
                                           "per_atom_energy"),
                    "plain_f32_F_rel": err(plain, f_scale, "forces"),
                    "table_shape": list(cp.coeffs.shape),
                    "pack_s": t_pack}
        del cp, g32
        check(comp[gt]["E_rel"] <= COMPENSATED_GATE,
              f"compensated {gt}: energies {comp[gt]['E_rel']} off")
        check(comp[gt]["F_rel"] <= COMPENSATED_GATE,
              f"compensated {gt}: forces {comp[gt]['F_rel']} off")
    torch.cuda.empty_cache()
    emit({"phase": "semantics_check", "float64_cases": cases,
          "compensated_bench_box": comp, "poses": N_COMPENSATED_POSES,
          "gate": {"semantics_E": 1e-12, "semantics_F": "1e-10 rel",
                   "compensated": COMPENSATED_GATE}})


# ----------------------------------------------------------------------
# The out-of-core path and float64 generation
# ----------------------------------------------------------------------

def _build_spills(name, f64):
    """Spill bytes ptxas reported for the kernel's instantiations of one
    scalar type."""
    from openmmgridforce_tpu_torch import cuda_build

    spilled, entry = 0, None
    for line in cuda_build.build_log(name).splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = found.group(1)
        if entry and f"E{'d' if f64 else 'f'}EEv" in entry:
            spilled += sum(int(b) for b in re.findall(r"(\d+) bytes spill",
                                                      line))
    return spilled


def phase_float64_kernels(torch, rec, rec_crd, counts, origin, sm_count):
    """Both kernels' float64 instantiations against their float64 twins:
    on the ragged shapes, and on the bench box (K1 over the whole grid, K2
    on slabs of x-planes at the grid's start, middle and end, the full
    float64 twin of K2 taking minutes); the cap exactly on an atom. Times
    each over the whole grid beside its FP64 bound. Returns the kernels
    line's facts per kernel."""
    from openmmgridforce_tpu_torch.ops import cuda_gridgen, cuda_gridgen_derivs
    from openmmgridforce_tpu_torch.ops.cuda_gridgen import (
        gridgen_values, gridgen_values_plain)
    from openmmgridforce_tpu_torch.ops.cuda_gridgen_derivs import (
        gridgen_derivs, gridgen_derivs_plain)
    from openmmgridforce_tpu_torch.ops.gridgen import receptor_atoms

    f64 = torch.float64
    worst = {"gridgen_values": 0.0, "gridgen_derivs": 0.0}
    misses = []
    for rc in RAGGED_COUNTS:
        geom = (rc, RAGGED_SPACING, RAGGED_ORIGIN)
        for n_atoms in RAGGED_ATOMS:
            for gt in GRID_TYPES:
                atoms = ragged_case(gt, rc, n_atoms, device="cuda",
                                    dtype=f64)
                got = gridgen_values(atoms, *geom, gt, RAGGED_CAP)
                ref = gridgen_values_plain(atoms, *geom, gt, RAGGED_CAP)
                err = float((got - ref).abs().max() / ref.abs().max())
                worst["gridgen_values"] = max(worst["gridgen_values"], err)
                if not (got.dtype == f64 and err < F64_GATE):
                    misses.append(f"values {gt} {rc} x {n_atoms}: {err}")
                got = gridgen_derivs(atoms, *geom, gt).reshape(-1, 27)
                ref = gridgen_derivs_plain(atoms, *geom, gt)
                err = float(_slot_err(got, ref).max())
                worst["gridgen_derivs"] = max(worst["gridgen_derivs"], err)
                if not (got.dtype == f64 and err < F64_GATE):
                    misses.append(f"derivs {gt} {rc} x {n_atoms}: {err}")
        last = [c - 1 for c in rc]
        point = (torch.tensor(RAGGED_ORIGIN, dtype=f64)
                 + torch.tensor(last, dtype=f64)
                 * torch.tensor(RAGGED_SPACING, dtype=f64))
        on_atom = torch.cat([point, torch.ones(1, dtype=f64)])[None]
        val = float(gridgen_values(on_atom.to("cuda"), *geom, "ljr",
                                   RAGGED_CAP)[tuple(last)])
        if val != RAGGED_CAP:
            misses.append(f"cap on the last point of {rc}: {val}")

    spacing = (SPACING,) * 3
    nx, nyz = counts[0], counts[1] * counts[2]
    n_points = nx * nyz
    planes = min(DERIV_CHECK_PLANES, nx)
    starts = sorted({0, (nx - planes) // 2, nx - planes})
    slab_counts = (planes,) + tuple(counts[1:])
    slab_points = len(starts) * planes * nyz
    per_type = {"gridgen_values": {}, "gridgen_derivs": {}}
    for gt in GRID_TYPES:
        atoms = receptor_atoms(gt, rec_crd, rec.charges, rec.sigmas,
                               rec.epsilons, dtype=f64, device="cuda")
        pairs = n_points * atoms.shape[0]
        columns = counts[0] * counts[1] * atoms.shape[0]
        # K1 over the whole grid against the twin over the whole grid
        args = (atoms, counts, spacing, origin, gt, GRID_CAP)
        got = gridgen_values(*args)
        ref = gridgen_values_plain(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ms = _cuda_ms(torch, lambda: gridgen_values(*args), 3)
        plain_ms = _cuda_ms(torch, lambda: gridgen_values_plain(*args), 1)
        bound = max((pairs * GRIDGEN_F64_OPS_PER_PAIR[gt] + columns
                     * GRIDGEN_OPS_PER_COLUMN_ATOM) / H100_FP64_FLOPS,
                    (atoms.numel() + n_points) * 8 / H100_BYTES_PER_S)
        # the bound before the double rsqrt / reciprocal were counted in
        # full (one operation each, the float32 count)
        bound_one_op = (pairs * GRIDGEN_OPS_PER_PAIR[gt] + columns
                        * GRIDGEN_OPS_PER_COLUMN_ATOM) / H100_FP64_FLOPS
        per_type["gridgen_values"][gt] = {
            "max_abs_err": err, "rel_err": err / float(ref.abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": 1e3 * bound,
            "bound_ms_one_op_rsqrt": 1e3 * bound_one_op,
            "bound_share": 1e3 * bound / ms,
            "bound_pipe": "fp64", "gpairs_per_s": pairs / ms / 1e6,
            "spill_bytes": _build_spills("gridgen_values", True),
            **_launch_facts("gridgen_values", cuda_gridgen, counts, gt,
                            sm_count, f64=True)}
        del got, ref
        # K2: the whole grid timed; slabs against the twin, kernel and
        # twin timed on the same slabs
        dargs = (atoms, counts, spacing, origin, gt)
        full_ms = _cuda_ms(torch, lambda: gridgen_derivs(*dargs), 1)

        def kernel_slabs():
            return [gridgen_derivs(atoms, slab_counts, spacing, origin, gt,
                                   index_offset=(x0, 0, 0))
                    for x0 in starts]

        def plain_slabs():
            return [gridgen_derivs_plain(atoms, counts, spacing, origin, gt,
                                         start=x0 * nyz,
                                         stop=(x0 + planes) * nyz)
                    for x0 in starts]

        got = torch.cat([g.reshape(-1, 27) for g in kernel_slabs()])
        ref = torch.cat(plain_slabs())
        torch.cuda.synchronize()
        err = _slot_err(got, ref)
        slab_ms = _cuda_ms(torch, kernel_slabs, 3)
        plain_ms = _cuda_ms(torch, plain_slabs, 1)
        slab_pairs = slab_points * atoms.shape[0]
        per_type["gridgen_derivs"][gt] = {
            "max_abs_err": float((got - ref).abs().max()),
            "rel_err": float(err.max()), "rel_err_slot": int(err.argmax()),
            "full_grid_ms": full_ms,
            "full_grid_bound_ms": 1e3 * pairs * DERIVS_OPS_PER_PAIR[gt]
            / H100_FP64_FLOPS,
            "slab_points": slab_points, "ms": slab_ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * slab_pairs * DERIVS_OPS_PER_PAIR[gt]
            / H100_FP64_FLOPS, "bound_pipe": "fp64",
            "tflops": pairs * DERIVS_OPS_PER_PAIR[gt] / full_ms / 1e9,
            "spill_bytes": _build_spills("gridgen_derivs", True),
            **_launch_facts("gridgen_derivs", cuda_gridgen_derivs, counts,
                            gt, sm_count, f64=True)}
        del got, ref
    on_atom = torch.tensor([[0.1, 0.1, 0.1, 1.0]], dtype=f64, device="cuda")
    cap_val = float(gridgen_values(on_atom, (3, 3, 3), (0.1,) * 3,
                                   (0.0,) * 3, "ljr", 500.0)[1, 1, 1])
    emit({"phase": "float64_kernels", "ragged_cases_per_kernel":
          len(RAGGED_COUNTS) * len(RAGGED_ATOMS) * len(GRID_TYPES),
          "ragged_worst_rel_err": worst, "misses": misses, "counts": counts,
          "atoms": int(rec_crd.shape[0]), "cap_on_atom": cap_val,
          "per_grid_type": per_type})
    check(not misses, f"float64 kernels: {misses}")
    check(cap_val == 500.0, f"float64 cap on atom gave {cap_val}")
    for name, rows in per_type.items():
        for gt, r in rows.items():
            check(r["rel_err"] < F64_GATE,
                  f"{name} float64 {gt}: rel err {r['rel_err']}")
    return per_type


def phase_float64_generation(torch, rec, rec_crd, counts, origin):
    """float64 grids of the bench box through generate_grid, values and
    27 derivatives, every grid type: the float64 instantiations on the
    path. Returns the launches per kernel."""
    from openmmgridforce_tpu_torch.ops import gridgen

    spacing = (SPACING,) * 3
    values_kernel, derivs_kernel = _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = {}
    for derivatives in (False, True):
        for gt in GRID_TYPES:
            g = gridgen.generate_grid(
                counts, spacing, origin, gt, rec_crd, rec.charges,
                rec.sigmas, rec.epsilons, grid_cap=GRID_CAP,
                compute_derivatives=derivatives, dtype=torch.float64,
                device="cuda")
            field = g.derivs if derivatives else g.vals
            out[(gt, derivatives)] = (g.vals.dtype == torch.float64
                                      and bool(torch.isfinite(field).all()))
            del g, field
    torch.cuda.synchronize()
    launches = {"gridgen_values": values_kernel.launches,
                "gridgen_derivs": derivs_kernel.launches}
    emit({"phase": "float64_generation", "counts": counts,
          "seconds": time.perf_counter() - t0, "launches": launches,
          "finite_float64": all(out.values())})
    check(all(out.values()), "float64 generation: non-finite or not float64")
    check(launches == {"gridgen_values": 3, "gridgen_derivs": 3},
          f"float64 generation launched {launches}")
    return launches


def stress_box(lig_crd):
    """The stress box centred on the ligand: (counts, origin)."""
    center = 0.5 * (lig_crd.min(0) + lig_crd.max(0))
    half = 0.5 * STRESS_SPACING * (np.array(STRESS_COUNTS) - 1)
    return STRESS_COUNTS, tuple(float(v) for v in center - half)


def phase_tiled_generation(torch, rec, rec_crd, lig_crd, counts, origin,
                           workdir):
    """OMGTILE files through generate_grid_to_tiled_file: the bench box's
    value and 27-derivative files, read back and held bit for bit against
    generate_grid of the same box; then the three stress-box value grids.
    Returns (launches of the tiled route per kernel, {grid type: stress
    file}, {grid type: bench derivative file})."""
    from openmmgridforce_tpu_torch.io import TiledGridReader
    from openmmgridforce_tpu_torch.ops import gridgen

    spacing = (SPACING,) * 3
    rec_args = (rec_crd, rec.charges, rec.sigmas, rec.epsilons)
    kernels = _reset_launches()
    launches = {"gridgen_values": 0, "gridgen_derivs": 0}

    def tiled(path, *args, **kw):
        """The tiled route, its launches added to ``launches``."""
        before = [k.launches for k in kernels]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gridgen.generate_grid_to_tiled_file(path, *args, **kw)
        torch.cuda.synchronize()
        for name, k, b in zip(launches, kernels, before):
            launches[name] += k.launches - b
        return time.perf_counter() - t0

    bench, deriv_files = {}, {}
    for derivatives in (False, True):
        for gt in GRID_TYPES:
            path = os.path.join(workdir, f"bench_{gt}_{int(derivatives)}"
                                ".tiled")
            seconds = tiled(path, counts, spacing, origin, gt, *rec_args,
                            tile_size=TILE_SIZE,
                            compute_derivatives=derivatives,
                            grid_cap=GRID_CAP, device="cuda")
            with TiledGridReader(path) as r:
                vals, derivs = r.read_full()
            mem = gridgen.generate_grid(
                counts, spacing, origin, gt, *rec_args, grid_cap=GRID_CAP,
                compute_derivatives=derivatives, device="cuda")
            same = np.array_equal(vals, mem.vals.cpu().numpy())
            if derivatives:
                same &= np.array_equal(derivs, np.moveaxis(
                    mem.derivs.cpu().numpy(), -1, 0))
                deriv_files[gt] = path
            else:
                os.remove(path)
            bench[f"{gt}{'_derivs' if derivatives else ''}"] = {
                "seconds": seconds, "bitwise_equal": bool(same)}
            del mem, vals, derivs

    s_counts, s_origin = stress_box(lig_crd)
    s_spacing = (STRESS_SPACING,) * 3
    points = int(np.prod(s_counts))
    stress, files = {}, {}
    for gt in GRID_TYPES:
        path = os.path.join(workdir, f"stress_{gt}.tiled")
        before = launches["gridgen_values"]
        seconds = tiled(path, s_counts, s_spacing, s_origin, gt, *rec_args,
                        tile_size=TILE_SIZE, grid_cap=GRID_CAP,
                        device="cuda")
        files[gt] = path
        stress[gt] = {"seconds": seconds,
                      "k1_launches": launches["gridgen_values"] - before,
                      "gb_written": os.path.getsize(path) / 1e9,
                      "pair_evals_per_s": points * rec_crd.shape[0]
                      / seconds}
    emit({"phase": "tiled_generation", "tile_size": TILE_SIZE,
          "bench_counts": counts, "bench": bench,
          "stress_counts": s_counts, "stress_spacing_nm": STRESS_SPACING,
          "stress_points": points, "stress": stress, "launches": launches})
    for name, r in bench.items():
        check(r["bitwise_equal"], f"tiled {name} differs from generate_grid")
    for gt, r in stress.items():
        check(r["k1_launches"] == -(-s_counts[0] // TILE_SIZE),
              f"stress {gt}: {r['k1_launches']} K1 launches")
    return launches, files, deriv_files


def _ligand_region(lig_crd, spacing, halo, margin):
    """Region shape holding the ligand's cloud plus halo and ``margin``
    cells a side (bench_canonical.py's auto-size)."""
    span = lig_crd.max(0) - lig_crd.min(0)
    need = np.ceil(span / spacing).astype(int) + 1 + halo
    return tuple(int(n + 2 * margin) for n in need)


def _rotations(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)


def _compare(torch, got, ref):
    e_err = float((got.energy.double() - ref.energy.double()).abs().max())
    f_err = float((got.forces.double() - ref.forces.double()).abs().max())
    e_scale = float(ref.energy.abs().max())
    f_scale = float(ref.forces.abs().max())
    return {"max_abs_E": e_scale, "E_rel": e_err / e_scale,
            "max_abs_F": f_scale, "F_rel": f_err / f_scale}


def phase_streamed_eval_check(torch, seed, lig, lig_crd, files, deriv_files,
                              counts):
    """StreamedGridEvaluator on the stress files (B-spline, a 256 MB native
    cache, below one 0.84 GB file): the ligand by evaluate, and 4,096
    docking poses spread over the box by evaluate_batch, against
    evaluate_grid on the whole grids held on the card; then the bench
    box's derivative files with triquintic regions against the in-memory
    triquintic grid."""
    from openmmgridforce_tpu_torch.grid import InterpolationMethod
    from openmmgridforce_tpu_torch.io import TiledGridReader
    from openmmgridforce_tpu_torch.io.streaming import StreamedGridEvaluator
    from openmmgridforce_tpu_torch.grid import grid_from_numpy
    from openmmgridforce_tpu_torch.ops import gridgen
    from openmmgridforce_tpu_torch.ops.interpolate import evaluate_grid

    rng = np.random.default_rng(seed + 7)
    scal = {gt: gridgen.auto_scaling_factors(gt, lig.charges, lig.sigmas,
                                             lig.epsilons)
            for gt in GRID_TYPES}
    # docking poses: random rotations of the ligand at sites placed so
    # that each site's poses share one lattice-aligned region
    centered = lig_crd - lig_crd.mean(0)
    radius = float(np.linalg.norm(centered, axis=1).max())
    need = int(np.ceil(2 * radius / STRESS_SPACING)) + 1 + 3
    shape = np.minimum(need + 2 * SCREEN_MARGIN, STRESS_COUNTS)
    s_counts = np.array(STRESS_COUNTS)
    with TiledGridReader(files["charge"]) as r:
        s_origin = np.array(r.origin)
    stride = np.maximum(shape // 2, 1)
    axes = [np.arange(0, max(c - n, 0) + 1, st)
            for c, n, st in zip(s_counts, shape, stride)]
    sites = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    sites = s_origin + (sites + shape // 2) * STRESS_SPACING
    which = rng.integers(0, len(sites), N_SCREEN_POSES)
    poses = (np.einsum("pij,nj->pni", _rotations(rng, N_SCREEN_POSES),
                       centered)
             + sites[which][:, None, :]
             + rng.uniform(-0.02, 0.02, (N_SCREEN_POSES, 1, 3)))
    poses_t = torch.as_tensor(poses, dtype=torch.float32, device="cuda")
    lig_t = torch.as_tensor(lig_crd, dtype=torch.float32, device="cuda")

    per_type, stats = {}, {}
    t_all = time.perf_counter()
    for gt in GRID_TYPES:
        sc = torch.as_tensor(scal[gt], dtype=torch.float32, device="cuda")
        region = _ligand_region(lig_crd, STRESS_SPACING, 3, STREAM_MARGIN)
        ev_lig, ev = (StreamedGridEvaluator(
            files[gt], InterpolationMethod.BSPLINE, region_shape=r,
            budget_bytes=NATIVE_BUDGET, device="cuda")
            for r in (region, tuple(int(v) for v in shape)))
        t0 = time.perf_counter()
        one = ev_lig.evaluate(lig_t, sc)
        torch.cuda.synchronize()
        t_lig = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch = ev.evaluate_batch(poses_t, sc)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with TiledGridReader(files[gt]) as r:
            vals, _ = r.read_full()
            full = grid_from_numpy(vals, r.spacing, r.origin,
                                   interp_method=InterpolationMethod.BSPLINE,
                                   device="cuda")
        del vals
        ref_one = evaluate_grid(full, lig_t, sc)
        ref_batch = evaluate_grid(full, poses_t, sc)
        cache = ev.cache_stats()
        per_type[gt] = {"ligand": _compare(torch, one, ref_one),
                        "ligand_s": t_lig, "ligand_region": list(region),
                        "ligand_native_cache": vars(ev_lig.cache_stats()),
                        "poses": _compare(torch, batch, ref_batch),
                        "poses_s": seconds,
                        "region_hits": ev.region_hits,
                        "region_misses": ev.region_misses,
                        "native_cache": vars(cache)}
        stats[gt] = cache
        ev.close()
        ev_lig.close()
        del full, ref_batch, batch
        torch.cuda.empty_cache()

    # triquintic regions of the bench box's derivative files
    tq = {}
    for gt in GRID_TYPES:
        sc = torch.as_tensor(scal[gt], dtype=torch.float32, device="cuda")
        with TiledGridReader(deriv_files[gt]) as r:
            vals, derivs = r.read_full()
            full = grid_from_numpy(
                vals, r.spacing, r.origin, derivs=derivs,
                interp_method=InterpolationMethod.TRIQUINTIC, device="cuda")
        region = _ligand_region(lig_crd, SPACING, 1, 24)
        ev = StreamedGridEvaluator(deriv_files[gt],
                                   InterpolationMethod.TRIQUINTIC,
                                   region_shape=region,
                                   budget_bytes=NATIVE_BUDGET,
                                   device="cuda")
        shift = rng.uniform(-0.1, 0.1, (N_TRIQUINTIC_POSES, 1, 3))
        tposes = torch.as_tensor(lig_crd + shift, dtype=torch.float32,
                                 device="cuda")
        tq[gt] = {"ligand": _compare(torch, ev.evaluate(lig_t, sc),
                                     evaluate_grid(full, lig_t, sc)),
                  "poses": _compare(torch, ev.evaluate_batch(tposes, sc),
                                    evaluate_grid(full, tposes, sc)),
                  "region_hits": ev.region_hits,
                  "region_misses": ev.region_misses}
        ev.close()
        del full
    emit({"phase": "streamed_eval_check", "stress_counts": STRESS_COUNTS,
          "native_budget_mb": NATIVE_BUDGET >> 20,
          "poses": N_SCREEN_POSES, "sites": len(sites),
          "pose_region_shape": [int(v) for v in shape],
          "seconds": time.perf_counter() - t_all,
          "bspline": per_type, "triquintic_bench_box": tq})
    for table in (per_type, tq):
        for gt, r in table.items():
            for what in ("ligand", "poses"):
                for key in ("E_rel", "F_rel"):
                    check(r[what][key] < 1e-4,
                          f"streamed {gt} {what} {key} {r[what][key]}")
    for gt, cache in stats.items():
        check(cache.evictions > 0, f"{gt}: the native cache evicted nothing")


def _rss_gb():
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1e6
    return None


def phase_streamed_path(torch, seed, lig, lig_crd, files,
                        n_steps=STREAM_STEPS):
    """bench_canonical.py's stress-md protocol on the port: 100 replicas at
    300 K, hydrogen mass 4, classic Langevin at 0.25 fs with friction 5/ps,
    B-spline regions holding the cloud plus halo plus 16 cells a side, one
    fused three-grid StreamSet with room for 1.5 packs, segments of 50
    steps; 100 warm-up steps, up to 2 drain rounds, ``n_steps`` timed
    steps (STREAM_STEPS by default, cut from 1,000) with the device
    memory they held, the same steps from fresh engines with groups padded
    to powers of two and at their own sizes, and one profiled short
    segment."""
    import contextlib
    import unittest.mock

    from openmmgridforce_tpu_torch.grid import InterpolationMethod
    from openmmgridforce_tpu_torch.io.streaming import StreamedGridEvaluator
    from openmmgridforce_tpu_torch.mm import (MDState, StreamedBatchMD,
                                              StreamSet, graphs, streamed_md,
                                              system_from_amber)
    from openmmgridforce_tpu_torch.ops import gridgen
    from openmmgridforce_tpu_torch.parallel import (init_replica_states,
                                                    redraw_hot_velocities,
                                                    replica_temperatures)

    region = _ligand_region(lig_crd, STRESS_SPACING, 3, STREAM_MARGIN)
    evs = [StreamedGridEvaluator(files[gt], InterpolationMethod.BSPLINE,
                                 region_shape=region, device="cuda")
           for gt in GRID_TYPES]
    scals = [gridgen.auto_scaling_factors(gt, lig.charges, lig.sigmas,
                                          lig.epsilons) for gt in GRID_TYPES]
    ncells = int(np.prod(np.asarray(region) - 1))
    pack_bytes = ncells * 64 * len(GRID_TYPES) * 4
    sset = StreamSet(evs, scals, pack_budget_bytes=int(pack_bytes * 1.5))
    system = system_from_amber(lig, dtype=torch.float32, hydrogen_mass=4.0,
                               device="cuda")
    md = StreamedBatchMD(sets=[sset], system=system, dt=STREAM_DT,
                         friction=STREAM_FRICTION,
                         refresh_steps=STREAM_REFRESH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    states = init_replica_states(
        gen, torch.as_tensor(lig_crd, dtype=torch.float32), system.masses,
        300.0, STREAM_REPLICAS, device="cuda")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = md.run(states, 300.0, STREAM_WARM)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    drained = []
    for _ in range(STREAM_DRAIN_ROUNDS):
        states, n_hot = redraw_hot_velocities(states, system.masses, 300.0,
                                              STREAM_DRAIN_K)
        drained.append(n_hot)
        if n_hot == 0:
            break
        states = md.run(states, 300.0, STREAM_DRAIN_STEPS)
    torch.cuda.synchronize()
    start = MDState(states.positions.clone(), states.velocities.clone(),
                    torch.Generator(device="cuda"))
    start.generator.set_state(states.generator.get_state())
    segments0 = md.segments
    recorded0 = dict(graphs.RECORDINGS)
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    states = md.run(states, 300.0, n_steps)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    segments = md.segments - segments0
    recorded = {k: graphs.RECORDINGS[k] - recorded0[k] for k in recorded0}
    memory = {"peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
              "reserved_gb": torch.cuda.memory_reserved() / 1e9,
              "reserved_growth_gb": (torch.cuda.memory_reserved()
                                     - reserved0) / 1e9,
              "recordings_kept": len(md._graphs)}
    # group sizes: the same timed steps from the same start and noise in
    # fresh engines over the same evaluators, groups padded to powers of
    # two (as shipped) and then recorded at their own sizes (whose run
    # finds the region and tile caches warmer)
    sizes, finals = {}, {}
    for policy in ("padded", "exact"):
        run_set = StreamSet(evs, scals,
                            pack_budget_bytes=int(pack_bytes * 1.5))
        run_md = StreamedBatchMD(sets=[run_set], system=system,
                                 dt=STREAM_DT, friction=STREAM_FRICTION,
                                 refresh_steps=STREAM_REFRESH)
        gen_p = torch.Generator(device="cuda")
        gen_p.set_state(start.generator.get_state())
        recorded0 = dict(graphs.RECORDINGS)
        ctx = (unittest.mock.patch.object(streamed_md, "_group_size",
                                          lambda b, n_rep: b)
               if policy == "exact" else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            finals[policy] = run_md.run(
                MDState(start.positions, start.velocities, gen_p), 300.0,
                n_steps)
            torch.cuda.synchronize()
            t_p = time.perf_counter() - t0
        sizes[policy] = {
            "replica_steps_per_s": n_steps * STREAM_REPLICAS / t_p,
            "timed_s": t_p, "segments": run_md.segments,
            "recordings": {k: graphs.RECORDINGS[k] - recorded0[k]
                           for k in recorded0},
            "crossing_retries": run_md.crossing_retries,
            "packs_built": run_set.packs_built,
            "direct_builds": run_set.direct_builds}
        del run_md, run_set
        gc.collect()       # the engines' recordings hold their packs
    dx_sizes, dv_sizes = _max_delta(torch, finals["padded"], finals["exact"])
    sizes["max_abs_dx_nm"], sizes["max_abs_dv_nm_per_ps"] = dx_sizes, dv_sizes
    del finals
    # windows of the same steps as graph replays and as eager launches,
    # from the final states under the same noise (the windows' states are
    # dropped; the engine's region state carries over)
    windows = {}
    for mode in ("graph", "eager"):
        gen_w = torch.Generator(device="cuda")
        gen_w.manual_seed(seed + 2)
        start = MDState(states.positions, states.velocities, gen_w)
        ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
        retries0 = md.crossing_retries
        with ctx:
            t0 = time.perf_counter()
            md.run(start, 300.0, EAGER_STEPS)
            torch.cuda.synchronize()
        windows[mode] = {
            "replica_steps_per_s": EAGER_STEPS * STREAM_REPLICAS
            / (time.perf_counter() - t0),
            "crossing_retries": md.crossing_retries - retries0}

    def segment():
        nonlocal states
        states = md.run(states, 300.0, STREAM_PROFILED_STEPS)
        torch.cuda.synchronize()

    profiled = {}
    for mode in ("graph", "eager"):
        ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            segment()                                   # warm-up
            wall_us, busy_us, n_ops, by_name = _profile(torch, segment,
                                                        host_ops=False)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        profiled[mode] = {
            "steps": STREAM_PROFILED_STEPS, "wall_ms": wall_us / 1e3,
            "device_ms_per_step": (busy_us / STREAM_PROFILED_STEPS / 1e3
                                   if n_ops else "not measured"),
            "device_ops_per_step": n_ops / STREAM_PROFILED_STEPS,
            "device_busy_share": (busy_us / wall_us if n_ops
                                  else "not measured"),
            "top_device_ms": {k[:80]: v / 1e3 for k, v in top}}

    # one streamed segment recorded and eager under the same noise: fresh
    # engines over the same evaluators, each drawing the segment's noise
    # from a generator seeded alike
    finals = {}
    for mode in ("graph", "eager"):
        check_set = StreamSet(evs, scals,
                              pack_budget_bytes=int(pack_bytes * 1.5))
        check_md = StreamedBatchMD(sets=[check_set], system=system,
                                   dt=STREAM_DT, friction=STREAM_FRICTION,
                                   refresh_steps=STREAM_REFRESH)
        gen_c = torch.Generator(device="cuda")
        gen_c.manual_seed(seed + 1)
        start = MDState(states.positions.clone(),
                        states.velocities.clone(), gen_c)
        ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            finals[mode] = check_md.run(start, 300.0,
                                        GRAPH_CHECK_STREAM_STEPS)
        torch.cuda.synchronize()
    dx, dv = _max_delta(torch, finals["graph"], finals["eager"])
    emit({"phase": "segment_graph_check", "path": "streamed_path",
          "replicas": STREAM_REPLICAS, "steps": GRAPH_CHECK_STREAM_STEPS,
          "groups": int(np.unique(check_set._starts, axis=0).shape[0]),
          "max_abs_dx_nm": dx, "max_abs_dv_nm_per_ps": dv,
          "bitwise_equal": dx == 0 and dv == 0, "gate": GRAPH_GATE})
    check(dx <= GRAPH_GATE and dv <= GRAPH_GATE, f"streamed_path: graph and "
          f"eager segments differ by {dx} nm, {dv} nm/ps")

    t_rep = replica_temperatures(states, system.masses)
    finite = bool(torch.isfinite(states.positions).all()
                  and torch.isfinite(states.velocities).all())
    pack = next(iter(sset._packed.values()))[0] if sset._packed else None
    emit({"phase": "streamed_path", "replicas": STREAM_REPLICAS,
          "ligand_atoms": lig.natom, "stress_counts": STRESS_COUNTS,
          "region_shape": list(region), "region_cells": ncells,
          "dt_ps": STREAM_DT, "friction": STREAM_FRICTION,
          "refresh_steps": STREAM_REFRESH, "warm_steps": STREAM_WARM,
          "warm_s": t_warm, "drained_per_round": drained,
          "timed_steps": [n_steps, STREAM_STEPS_REFERENCE],
          "timed_s": t_run, "groups_last_segment": int(np.unique(
              sset._starts, axis=0).shape[0]),
          "segments": segments, "steps_per_s": n_steps / t_run,
          "replica_steps_per_s": n_steps * STREAM_REPLICAS / t_run,
          "recordings_in_timed_steps": recorded,
          "device_memory": memory,
          "group_sizes_fresh_engines": sizes,
          "window_steps": EAGER_STEPS,
          "graph_window": windows["graph"],
          "eager_window": windows["eager"],
          "profiled_segment": profiled,
          "packs_built": sset.packs_built,
          "direct_builds": sset.direct_builds,
          "full_escalations": sset.full_escalations,
          "crossing_retries": md.crossing_retries,
          "region_misses": [ev.region_misses for ev in evs],
          "fused_pack_gb": (pack.coeffs.numel() * pack.coeffs.element_size()
                            / 1e9 if pack is not None else None),
          "host_rss_gb": _rss_gb(),
          "device_max_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "finite": finite, "median_T": float(t_rep.median()),
          "max_T": float(t_rep.max())})
    for ev in evs:
        ev.close()
    check(finite, "streamed_path: non-finite positions or velocities")
    check(100.0 < float(t_rep.median()) < 600.0,
          f"streamed_path: median T {float(t_rep.median())} K")
    check(float(t_rep.max()) < 20000.0,
          f"streamed_path: a replica reached {float(t_rep.max())} K")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--stream-steps", type=int, default=STREAM_STEPS,
                        help="timed steps of streamed_path (the stress-md "
                             "protocol's are 1,000)")
    args = parser.parse_args(argv)
    faulthandler.enable()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # outside a checkout of the repository this fails before any output
    import openmmgridforce_tpu_torch  # noqa: F401

    smi, sm_count = phase_device(torch)
    phase_build()
    phase_sass()
    phase_ragged(torch)
    phase_twofloat_check(torch, args.seed)

    lig, lig_crd, rec, rec_crd = synthetic_complex(args.seed)
    counts, origin = grid_box(lig_crd)
    complex_ = (lig, lig_crd, rec, rec_crd, counts, origin)
    checks = {
        "gridgen_values": phase_kernel_check(torch, rec, rec_crd, counts,
                                             origin, sm_count),
        "gridgen_derivs": phase_kernel_check_derivs(torch, rec, rec_crd,
                                                    counts, origin,
                                                    sm_count)}
    launches = {"gridgen_values": {}, "gridgen_derivs": {}}
    system, binding, _, states, launches["gridgen_values"]["main_path"] = \
        phase_main_path(torch, args.seed, *complex_)
    phase_eval_check(torch, lig, system, binding, states)
    phase_step_profile(torch, system, binding, states)
    temps = torch.full((N_REPLICAS,), 300.0, device="cuda")
    phase_segment_graph_check(torch, "main_path", system, binding, states,
                              GRAPH_CHECK_STEPS, 0.001, temps, args.seed)
    phase_capture_failure()
    del binding

    system, binding, hermite, states, \
        launches["gridgen_derivs"]["deriv_path"] = \
        phase_deriv_path(torch, args.seed, *complex_)
    phase_deriv_setup_times(torch, rec, rec_crd, counts, origin)
    phase_deriv_eval_check(torch, lig, system, binding, hermite, states)
    phase_step_profile(torch, system, binding, states,
                       phase="deriv_step_profile")
    phase_segment_graph_check(torch, "deriv_path", system, binding, states,
                              GRAPH_CHECK_STEPS, 0.001, temps, args.seed)
    del binding, hermite
    phase_semantics_check(torch, args.seed, *complex_)

    lig, lig_crd, rec, rec_crd = synthetic_complex(args.seed,
                                                   gap=BPMF_RECEPTOR_GAP)
    check(grid_box(lig_crd) == (counts, origin), "the BPMF complex's "
          "ligand differs from the other paths'")
    launches["gridgen_values"]["bpmf_path"] = phase_bpmf_path(
        torch, args.seed, lig, lig_crd, rec, rec_crd, counts, origin)
    api_launches = phase_api_path(torch, args.seed, smi, lig, lig_crd, rec,
                                  rec_crd, counts, origin)
    launches["gridgen_values"]["api_path"] = api_launches["gridgen_values"]

    lig, lig_crd, rec, rec_crd = synthetic_complex(args.seed)
    checks_f64 = phase_float64_kernels(torch, rec, rec_crd, counts, origin,
                                       sm_count)
    launches_f64 = phase_float64_generation(torch, rec, rec_crd, counts,
                                            origin)
    # the tiles live in the checkout, in a directory .gitignore lists
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_tiles_",
                               dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        tiled_launches, files, deriv_files = phase_tiled_generation(
            torch, rec, rec_crd, lig_crd, counts, origin, workdir)
        for name, n in tiled_launches.items():
            launches[name]["tiled_generation"] = n
        phase_streamed_eval_check(torch, args.seed, lig, lig_crd, files,
                                  deriv_files, counts)
        phase_streamed_path(torch, args.seed, lig, lig_crd, files,
                            args.stream_steps)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    replaces = {
        "gridgen_values": "openmmgridforce_tpu/ops/pallas_gridgen.py:39",
        "gridgen_derivs":
            "openmmgridforce_tpu/ops/pallas_gridgen_derivs.py:36"}
    # the gated error of each kernel: max |kernel - plain| over max |plain|
    # (per derivative slot for gridgen_derivs, whose raw sums reach 1e33)
    rel_key = {"gridgen_values": "rel_err", "gridgen_derivs": "rel_err_f32"}
    def line(name, per_type, by_path, rel, source):
        return {
            "name": name, "route": "cuda",
            "source": f"openmmgridforce_tpu_torch/csrc/{source}.cu",
            "replaces": replaces[source],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in per_type.values()),
            "max_rel_err": max(r[rel] for r in per_type.values()),
            "ms": sum(r["ms"] for r in per_type.values()),
            "plain_ms": sum(r["plain_ms"] for r in per_type.values()),
            "bound_ms": sum(r["bound_ms"] for r in per_type.values()),
            "bound_by": ("bytes" if all(r["bound_pipe"] == "bytes"
                                        for r in per_type.values())
                         else "operations"),
            "library_ms": None}

    # the float64 instantiations are timed over the whole bench grid (K1)
    # and over the checked slabs (K2), kernel, twin and bound alike
    emit({"kernels": [
        line(name, per_type, launches[name], rel_key[name], name)
        for name, per_type in checks.items()] + [
        line(f"{name}_f64", checks_f64[name],
             {"float64_generation": launches_f64[name],
              "api_path": api_launches[f"{name}_f64"]}, "rel_err", name)
        for name in checks_f64]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
