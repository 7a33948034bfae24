#!/usr/bin/env python
"""Multi-pose docking screen on the PyTorch/CUDA port: the torch twin of
examples/docking_screen.py.

Scores thousands of ligand poses in one batch: the poses are a leading
batch dimension over one fused multi-grid evaluation (B-spline packs of
the charge, ljr and lja grids generated through the hand-written values
kernel), so per-pose energies fall out as the batched result. With
--streamed the same screen runs out of core: the grids are written to
OMGTILE files (``write_grid_tiled``) and the poses scored by
``StreamedGridEvaluator.evaluate_batch``, grouped by lattice-aligned
region through the native tile cache.

    python examples/docking_screen_torch.py --data DIR [--poses 4096]
        [--spacing 0.025] [--streamed] [--device cuda|cpu]

``--data`` holds receptor.prmtop, receptor.trans.inpcrd, ligand.prmtop and
ligand.trans.inpcrd (AMBER files).
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.isdir(os.path.join(_repo, "openmmgridforce_tpu_torch")):
    sys.path.insert(0, _repo)

GRID_TYPES = ("charge", "ljr", "lja")


def random_poses(rng, crd, zmatrix, primary, n_poses, torsion_sigma=0.8,
                 translate_sigma=0.15):
    """Perturb torsions in BAT space plus a rigid-body jitter."""
    from openmmgridforce_tpu_torch.sampling import bat_to_xyz, xyz_to_bat

    base = xyz_to_bat(crd, zmatrix, primary)
    n_t = len(zmatrix)
    poses = np.empty((n_poses,) + crd.shape, np.float32)
    for p in range(n_poses):
        b = base.copy()
        b[9 + 2 * n_t:] += rng.normal(0.0, torsion_sigma, n_t)
        b[:3] += rng.normal(0.0, translate_sigma, 3)
        poses[p] = bat_to_xyz(b, zmatrix, primary)
    return poses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=4096)
    ap.add_argument("--spacing", type=float, default=0.025)
    ap.add_argument("--data", required=True,
                    help="directory of receptor.prmtop, "
                         "receptor.trans.inpcrd, ligand.prmtop and "
                         "ligand.trans.inpcrd")
    ap.add_argument("--streamed", action="store_true",
                    help="also score out-of-core: grids written to tiled "
                         "files, poses grouped by region via "
                         "StreamedGridEvaluator.evaluate_batch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from openmmgridforce_tpu_torch import InterpolationMethod, resolve_device
    from openmmgridforce_tpu_torch.mm import (GridBinding, load_inpcrd,
                                              load_prmtop, potential_energy,
                                              system_from_amber)
    from openmmgridforce_tpu_torch.mm.system import grid_energy
    from openmmgridforce_tpu_torch.ops import gridgen
    from openmmgridforce_tpu_torch.ops.packed import (combine_packed_grids,
                                                      pack_grid)
    from openmmgridforce_tpu_torch.sampling import build_zmatrix

    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    rec = load_prmtop(f"{args.data}/receptor.prmtop")
    rec_crd = load_inpcrd(f"{args.data}/receptor.trans.inpcrd")
    lig = load_prmtop(f"{args.data}/ligand.prmtop")
    lig_crd = load_inpcrd(f"{args.data}/ligand.trans.inpcrd")

    lo = lig_crd.min(0) - 0.8
    counts = tuple(int(c) + 1 for c in
                   np.ceil((lig_crd.max(0) + 0.8 - lo) / args.spacing))
    print(f"grids {counts} from {rec.natom} receptor atoms", flush=True)

    t0 = time.perf_counter()
    packs, scals, raw_grids = [], [], []
    for gt in GRID_TYPES:
        g = gridgen.generate_grid(
            counts, (args.spacing,) * 3, tuple(lo), gt, rec_crd,
            rec.charges, rec.sigmas, rec.epsilons,
            interp_method=InterpolationMethod.BSPLINE, device=device)
        raw_grids.append(g)
        packs.append(pack_grid(g))
        scals.append(gridgen.auto_scaling_factors(
            gt, lig.charges, lig.sigmas, lig.epsilons))
    binding = GridBinding(grid=combine_packed_grids(packs),
                          scaling=torch.as_tensor(np.stack(scals),
                                                  dtype=torch.float32,
                                                  device=device))
    sync()
    print(f"generated + packed in {time.perf_counter() - t0:.1f}s",
          flush=True)

    system = system_from_amber(lig, dtype=torch.float32, device=device)
    z, primary = build_zmatrix(lig.masses, [tuple(b) for b in lig.bond_idx])
    rng = np.random.default_rng(0)
    poses = torch.as_tensor(random_poses(rng, lig_crd, z, primary,
                                         args.poses), device=device)

    with torch.no_grad():
        potential_energy(system, [binding], poses)      # warm-up
        sync()
        t0 = time.perf_counter()
        e = potential_energy(system, [binding], poses)
        sync()
        dt = time.perf_counter() - t0
    e = e.cpu().numpy()
    order = np.argsort(e)
    print(f"scored {args.poses} poses in {dt * 1e3:.1f} ms "
          f"({args.poses / dt:,.0f} poses/s)")
    print("top 5 poses (kJ/mol):",
          np.array2string(e[order[:5]], precision=2))
    crystal = torch.as_tensor(lig_crd, dtype=torch.float32, device=device)
    print(f"crystal pose energy: "
          f"{float(potential_energy(system, [binding], crystal)):.2f}")
    result = {"energies": e}

    if args.streamed:
        # out-of-core: the same screen with the grids on disk (OMGTILE),
        # poses grouped by lattice-aligned region
        from openmmgridforce_tpu_torch.io import write_grid_tiled
        from openmmgridforce_tpu_torch.io.streaming import (
            StreamedGridEvaluator)

        tdir = tempfile.mkdtemp(prefix="screen_tiles_")
        evs = []
        for gt, g in zip(GRID_TYPES, raw_grids):
            path = os.path.join(tdir, f"{gt}.tiled")
            write_grid_tiled(path, g, tile_size=32)
            evs.append(StreamedGridEvaluator(
                path, InterpolationMethod.BSPLINE, device=device))

        def grids_streamed():
            eg = 0.0
            for ev, scal in zip(evs, scals):
                eg = eg + ev.evaluate_batch(poses, scal).energy
            return eg.cpu().numpy()

        with torch.no_grad():
            eg_s = grids_streamed()          # first region reads
            sync()
            t0 = time.perf_counter()
            eg_s = grids_streamed()          # warm: device-LRU regions
            sync()
            dt_s = time.perf_counter() - t0
            # parity on the grid term (the part streaming replaces), over
            # fully-in-box poses: an out-of-box atom draws one fused
            # restraint in memory but one per grid file here
            eg_m = grid_energy([binding], poses).cpu().numpy()
        hi = lo + (np.asarray(counts) - 1) * args.spacing
        p = poses.cpu().numpy()
        in_box = np.all((p >= lo) & (p <= hi), axis=(1, 2))
        rel = (np.abs(eg_s - eg_m)[in_box]
               / np.maximum(np.abs(eg_m[in_box]), 1.0))
        print(f"streamed (out-of-core): {args.poses / dt_s:,.0f} poses/s "
              f"warm; grid-energy rel |dE| vs in-memory median "
              f"{np.median(rel) if rel.size else 0.0:.1e} / max "
              f"{rel.max() if rel.size else 0.0:.1e} over "
              f"{int(in_box.sum())}/{args.poses} in-box poses; "
              f"region hits/misses "
              f"{sum(ev.region_hits for ev in evs)}/"
              f"{sum(ev.region_misses for ev in evs)}")
        for ev in evs:
            ev.close()
        result.update(streamed=eg_s, in_memory=eg_m, in_box=in_box)
    return result


if __name__ == "__main__":
    main()
