#!/usr/bin/env python
"""BPMF production workflow on the PyTorch/CUDA port: the torch twin of
examples/bpmf_sampler.py.

    python examples/bpmf_sampler_torch.py -i input.json --generate-grids \
        [--device cuda|cpu] [--n-trials N] [--friction 5] [--drain-rounds 2] \
        [--dp N [--sp M]]

Reads the same input.json schema (run_job/nstate/ntrial_repX/ntrial_gMC/
nstep_MD/nstep_equil at the top level, T_HIGH/T_SIMMIN/H_mass/delta_t in
the job section, AMBER file paths under 'dir'), regenerates the charge,
ljr and lja grids from the receptor over the ligand's bounds +- 1 nm
(on the card through the hand-written values kernel), packs them as cubic
B-splines fused slab by slab (``pack_grids_fused``, 16-cell slabs), builds
an HBonds-constrained system with repartitioned hydrogen masses, and runs
the temperature-ladder sampler with every rung batched on one device.
Writes energies.dat and traj.xyz (and a checkpoint every 50 trials) into
the work directory.

Without --generate-grids the grids are read from the files that
input.json names under "grids" ("direct_elec", "LJr", "LJa"): AlGDock
NetCDF (.nc, Angstrom and kcal/mol) or V3 binary (.grid), each a B-spline
pack of its own, as in the JAX example.

``--dp N --sp M`` run the ladder on a mesh of N x M ranks
(``openmmgridforce_tpu_torch.parallel``): rungs split over dp, and with
M > 1 the fused table over sp (generated slab by slab on the sp ranks:
--sp needs --generate-grids). The example starts its own ranks, one process
each: gloo on the host with ``--device cpu``, NCCL when the machine has
N x M cards, else gloo with every rank on the one card. Under ``torchrun
--nproc-per-node N*M`` it joins torchrun's ranks instead. Rank 0 alone
writes energies.dat, traj.xyz and the checkpoints.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# allow running from a source checkout without installation
_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.isdir(os.path.join(_repo, "openmmgridforce_tpu_torch")):
    sys.path.insert(0, _repo)

GRID_TYPES = ("charge", "ljr", "lja")
# fused three-grid B-spline rows are 192 floats; above this many table
# bytes the fusion splits into (charge + ljr | lja), the grouping rule of
# examples/bpmf_sampler.py
FUSED_TABLE_LIMIT = 6.8e9
X_CHUNK = 16


def generate_grids(cfg, lig_crd, margin, spacing, device, mesh=None):
    """Charge/ljr/lja B-spline grids from the receptor named in input.json,
    over the ligand's bounds +- ``margin`` nm at ``spacing`` nm; with a
    mesh of more than one sp rank, this rank's x-slabs of them."""
    from openmmgridforce_tpu_torch.grid import InterpolationMethod
    from openmmgridforce_tpu_torch.mm import load_inpcrd, load_prmtop
    from openmmgridforce_tpu_torch.ops import gridgen
    from openmmgridforce_tpu_torch.parallel import generate_grid_sharded

    paths = cfg.get("dir", {})
    for k in ("receptor_prmtop", "receptor_inpcrd"):
        if k not in paths:
            raise SystemExit(f"input.json: --generate-grids needs '{k}' "
                             "under 'dir'")
    rec = load_prmtop(paths["receptor_prmtop"])
    rec_crd = load_inpcrd(paths["receptor_inpcrd"])
    lo = lig_crd.min(0) - margin
    counts = tuple(int(c) + 1 for c in
                   np.ceil((lig_crd.max(0) + margin - lo) / spacing))
    print(f"generating grids {counts} from {rec.natom} receptor atoms",
          flush=True)
    args = (counts, (spacing,) * 3, lo)
    fields = (rec_crd, rec.charges, rec.sigmas, rec.epsilons)
    if _sp(mesh) > 1:
        return [generate_grid_sharded(
            mesh, *args, gt, *fields,
            interp_method=InterpolationMethod.BSPLINE) for gt in GRID_TYPES]
    return [gridgen.generate_grid(
        *args, gt, *fields, interp_method=InterpolationMethod.BSPLINE,
        device=device) for gt in GRID_TYPES]


def _sp(mesh):
    return mesh.size("sp") if mesh is not None else 1


def file_binding(path, unit_conversion, scaling, device):
    """The B-spline pack of one grid file (examples/bpmf_sampler.py's
    get_grid_binding): AlGDock NetCDF in Angstrom, or V3 in nm; values
    times ``unit_conversion``."""
    import torch

    from openmmgridforce_tpu_torch.grid import (InterpolationMethod,
                                                grid_from_numpy)
    from openmmgridforce_tpu_torch.mm import GridBinding
    from openmmgridforce_tpu_torch.ops.packed import pack_grid
    from openmmgridforce_tpu_torch.units import ANGSTROM_TO_NM

    if path.endswith(".nc"):
        from openmmgridforce_tpu_torch.io import read_netcdf
        data = read_netcdf(path)
        counts = data["counts"]
        spacing = tuple(s * ANGSTROM_TO_NM for s in data["spacing"])
        origin = tuple(o * ANGSTROM_TO_NM for o in data["origin"])
        vals = np.asarray(data["vals"]).reshape(counts) * unit_conversion
    else:
        from openmmgridforce_tpu_torch.io import load_v3
        d = load_v3(path)
        spacing, origin = d.spacing, d.origin
        vals = d.vals * unit_conversion
    grid = grid_from_numpy(vals, spacing, origin,
                           interp_method=InterpolationMethod.BSPLINE,
                           dtype=torch.float32, device=device)
    return GridBinding(grid=pack_grid(grid), scaling=torch.as_tensor(
        scaling, dtype=torch.float32, device=device))


def fused_bindings(grids, scalings, device, mesh=None):
    """GridBindings of the grids, fused as one table where it fits, else
    as (charge + ljr | lja); with a mesh of more than one sp rank, one
    table packed from this rank's slabs (the sampler needs one binding
    to shard)."""
    import torch

    from openmmgridforce_tpu_torch.mm import GridBinding
    from openmmgridforce_tpu_torch.ops.packed import pack_grids_fused
    from openmmgridforce_tpu_torch.parallel import pack_sharded

    if _sp(mesh) > 1:
        return [GridBinding(
            grid=pack_sharded(grids, x_chunk=X_CHUNK),
            scaling=torch.as_tensor(np.stack(scalings), dtype=torch.float32,
                                    device=device))]
    ncells = int(np.prod([c - 1 for c in grids[0].counts]))
    groups = ([[0, 1], [2]] if ncells * 256 * 4 > FUSED_TABLE_LIMIT
              else [[0, 1, 2]])
    return [GridBinding(
        grid=pack_grids_fused([grids[i] for i in grp], x_chunk=X_CHUNK,
                              device=device),
        scaling=torch.as_tensor(np.stack([scalings[i] for i in grp]),
                                dtype=torch.float32, device=device))
        for grp in groups]


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("--n-trials", type=int, default=100)
    ap.add_argument("--generate-grids", action="store_true",
                    help="regenerate grids from the receptor instead of "
                         "reading the files named under 'grids'")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--grid-spacing", type=float, default=0.025,
                    help="spacing (nm) for --generate-grids")
    ap.add_argument("--dp", type=int, default=0,
                    help="ranks the rungs split over (0: no mesh)")
    ap.add_argument("--sp", type=int, default=1,
                    help="ranks the fused grid table splits over (with "
                         "--generate-grids)")
    ap.add_argument("--friction", type=float, default=1.0,
                    help="Langevin friction (ps^-1). The reference example "
                         "uses 1/ps; on capped grids a fusion event spikes "
                         "a rung's temperature and friction sets the drain "
                         "rate: 5/ps keeps the ladder finite where 1/ps "
                         "lets spikes compound during equilibration")
    ap.add_argument("--drain-rounds", type=int, default=0,
                    help="split equilibration into this many chunks and "
                         "re-draw velocities of fusion-trapped states "
                         "between chunks (0 = one uninterrupted run)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def _summary(sampler):
    return {"n_exchange_attempted": sampler.n_exchange_attempted,
            "n_exchange_accepted": sampler.n_exchange_accepted,
            "n_gmc_attempted": sampler.n_gmc_attempted,
            "n_gmc_accepted": sampler.n_gmc_accepted,
            "energies": sampler.potential_energies()}


def _rank_main(device, argv):
    """One rank of a mesh this example started (``main``)."""
    from openmmgridforce_tpu_torch.parallel import Mesh

    args = parse_args(argv)
    mesh = Mesh((args.dp, args.sp), ("dp", "sp"), device)
    return _summary(run(args, device, mesh))


def main(argv=None):
    """Run the example; with --dp/--sp a mesh of ranks, started here
    (returns rank 0's summary) or joined under torchrun."""
    args = parse_args(argv)
    n_ranks = max(args.dp, 1) * args.sp
    if n_ranks == 1:
        from openmmgridforce_tpu_torch import resolve_device
        return run(args, resolve_device(args.device))

    import torch

    from openmmgridforce_tpu_torch.parallel import Mesh, distributed

    if args.dp < 1:
        raise SystemExit("--sp needs --dp (the rungs' ranks, 1 or more)")
    if args.sp > 1 and not args.generate_grids:
        raise SystemExit("--sp splits the fused table that --generate-grids "
                         "makes; the grid files are a pack each")
    if "WORLD_SIZE" in os.environ:              # torchrun started the ranks
        device = distributed.initialize(device=args.device)
        mesh = Mesh((args.dp, args.sp), ("dp", "sp"), device)
        return _summary(run(args, device, mesh))
    on_host = args.device is not None and args.device.startswith("cpu")
    backend = ("gloo" if on_host or torch.cuda.device_count() < n_ranks
               else "nccl")
    print(f"starting {n_ranks} ranks ({args.dp} dp x {args.sp} sp), "
          f"backend {backend}", flush=True)
    return distributed.launch(_rank_main, n_ranks, (argv,), backend=backend,
                              device="cpu" if on_host else None)[0]


def run(args, device, mesh=None):
    """The workflow on ``device`` (on a mesh: this rank's part)."""
    import torch

    from openmmgridforce_tpu_torch.mm import (load_inpcrd, load_prmtop,
                                              system_from_amber)
    from openmmgridforce_tpu_torch.sampling import Sampler, SamplerConfig
    from openmmgridforce_tpu_torch.units import KCAL_TO_KJ
    from openmmgridforce_tpu_torch.utils import save_sampler, write_xyz_frame

    writer = mesh is None or mesh.rank == 0
    with open(args.input) as fh:
        cfg = json.load(fh)

    def require(d, key, where):
        if key not in d:
            raise SystemExit(
                f"input.json: missing key '{key}' in {where} (reference "
                "schema: run_job/nstate/ntrial_repX/ntrial_gMC/nstep_MD at "
                "the top level; T_HIGH/T_SIMMIN/H_mass/delta_t inside the "
                "job section named by run_job; file paths under 'dir')")
        return d[key]

    run_job = require(cfg, "run_job", "the top level")
    job = require(cfg, run_job, "the top level (the job section)")
    dtype = torch.float32

    paths = require(cfg, "dir", "the top level")
    lig = load_prmtop(require(paths, "ligand_prmtop", "'dir'"))
    lig_crd = load_inpcrd(require(paths, "ligand_inpcrd", "'dir'"))
    system = system_from_amber(lig, dtype=dtype,
                               hydrogen_mass=job.get("H_mass"),
                               constraints="HBonds", device=device)

    # per-atom scaling factors with the sampler's conventions
    # (sampler.py:497-520: charge; sqrt(eps)*(2 rVdw)^6; sqrt(eps)*(2 rVdw)^3
    # where rVdw = Rmin/2 = 2^(1/6) sigma / 2)
    rvdw = (2.0 ** (1.0 / 6.0)) * lig.sigmas / 2.0
    scalings = [lig.charges, np.sqrt(lig.epsilons) * (2.0 * rvdw) ** 6,
                np.sqrt(lig.epsilons) * (2.0 * rvdw) ** 3]

    bindings = []
    # the reference adds grid forces only for the complex ('CD') job;
    # 'BC' samples the isolated ligand (sampler.py:484-521)
    if run_job != "BC" and args.generate_grids:
        t0 = time.perf_counter()
        grids = generate_grids(cfg, lig_crd, margin=1.0,
                               spacing=args.grid_spacing, device=device,
                               mesh=mesh)
        bindings = fused_bindings(grids, scalings, device, mesh)
        del grids
        print(f"grids generated and packed in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    elif run_job != "BC":
        gpaths = require(cfg, "grids", "the top level (or pass "
                         "--generate-grids)")
        specs = [(require(gpaths, "direct_elec", "'grids'"), KCAL_TO_KJ),
                 (require(gpaths, "LJr", "'grids'"),
                  np.sqrt(KCAL_TO_KJ) * 1.0e6),
                 (require(gpaths, "LJa", "'grids'"),
                  np.sqrt(KCAL_TO_KJ) * 1.0e3)]
        bindings = [file_binding(path, conv, scal, device)
                    for (path, conv), scal in zip(specs, scalings)]

    nstate = require(cfg, "nstate", "the top level")
    scfg = SamplerConfig(
        n_states=nstate,
        t_high=require(job, "T_HIGH", f"job '{run_job}'"),
        t_min=require(job, "T_SIMMIN", f"job '{run_job}'"),
        dt=require(job, "delta_t", f"job '{run_job}'") / 1000.0,  # fs -> ps
        friction=args.friction,
        md_steps_per_trial=require(cfg, "nstep_MD", "the top level"),
        hydrogen_mass=job.get("H_mass"),
    )
    sampler = Sampler(system, bindings, lig_crd, scfg,
                      bonds=[tuple(b) for b in lig.bond_idx], mesh=mesh,
                      device=device)

    n_repx = require(cfg, "ntrial_repX", "the top level")
    n_gmc = require(cfg, "ntrial_gMC", "the top level")
    work_dir = args.work_dir or os.path.join(
        cfg.get("work_dir", "."), run_job, f"{nstate}_{n_repx}_{n_gmc}")
    os.makedirs(work_dir, exist_ok=True)
    sink = os.devnull if not writer else None

    with open(sink or os.path.join(work_dir, "energies.dat"), "w") as \
            energy_file, \
            open(sink or os.path.join(work_dir, "traj.xyz"), "w") as xyz_file:
        def report(trial, s):
            # every rank gathers (collectives); rank 0 writes
            e = s.potential_energies()
            pos = s.positions().cpu().numpy()
            if trial % 50 == 49:
                save_sampler(os.path.join(work_dir, "checkpoint"), s)
            if not writer:
                return
            energy_file.write("".join(f"{v / KCAL_TO_KJ:12.4f}"
                                      for v in e) + "\n")
            energy_file.flush()
            for istate in (0, len(e) - 1):
                write_xyz_frame(xyz_file,
                                f"state {istate} E={e[istate]:.3f}",
                                pos[istate])

        t0 = time.perf_counter()
        # equilibration before production (sampler.py:551), in
        # --drain-rounds chunks: between chunks, fusion-trapped rungs
        # (instantaneous T > 5x their ladder T) get fresh velocities
        nstep_equil = int(cfg.get("nstep_equil", 0))
        if nstep_equil > 0:
            chunks = max(1, args.drain_rounds)
            per = max(1, nstep_equil // chunks)
            for i in range(chunks):
                sampler.run_md(per)
                if args.drain_rounds > 0:
                    n_hot = sampler.drain_trapped()
                    if n_hot and writer:
                        print(f"equil chunk {i + 1}/{chunks}: re-drew "
                              f"velocities of {n_hot} trapped states")

        sampler.run(n_trials=args.n_trials, n_exchange_per_trial=n_repx,
                    n_gmc_per_trial=n_gmc, callback=report)
        if device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0

    if not writer:
        return sampler
    steps = args.n_trials * scfg.md_steps_per_trial * nstate
    print(f"{args.n_trials} trials in {elapsed:.1f}s on {device} "
          f"({steps / elapsed:,.0f} replica-steps/s)")
    print(f"exchange acceptance: "
          f"{sampler.n_exchange_accepted}/{sampler.n_exchange_attempted}")
    if sampler.n_gmc_attempted:
        print(f"gMC acceptance: "
              f"{sampler.n_gmc_accepted}/{sampler.n_gmc_attempted}")
    return sampler


if __name__ == "__main__":
    main()
