"""The system under test, driven through its public entry points.

Everything the benchmark takes from ``openmmgridforce_tpu_torch`` goes
through this module: building the ligand's System (constrained where the
configuration says so), generating and packing a receptor's grids, the
Langevin segment runner, the replica-exchange sampler, and the counters a
kind reads (recordings that hold WHILE nodes, the constraint solvers'
sweeps). The benchmark hands it the complex and the window's inputs; it
hands back the program's own objects and outputs.
"""

from __future__ import annotations

import numpy as np
import torch

GRID_METHODS = {"bspline": "BSPLINE", "triquintic": "TRIQUINTIC"}


def topology(ligand):
    """The port's AmberTopology of the benchmark's ligand."""
    from openmmgridforce_tpu_torch.mm.amber import AmberTopology

    return AmberTopology(
        natom=ligand.natom, masses=ligand.masses, charges=ligand.charges,
        sigmas=ligand.sigmas, epsilons=ligand.epsilons,
        atom_names=list(ligand.elements), residue_labels=["LIG"],
        residue_pointers=np.array([1]), bond_idx=ligand.bond_idx,
        bond_k=ligand.bond_k, bond_r0=ligand.bond_r0,
        angle_idx=ligand.angle_idx, angle_k=ligand.angle_k,
        angle_t0=ligand.angle_t0, torsion_idx=ligand.torsion_idx,
        torsion_k=ligand.torsion_k, torsion_per=ligand.torsion_per,
        torsion_phase=ligand.torsion_phase, exclusions=ligand.exclusions,
        pairs14=ligand.pairs14, scee=ligand.scee, scnb=ligand.scnb)


def system(ligand, config, device):
    """The ligand's System: hydrogen mass and constraints (None,
    "HBonds" or "AllBonds") from the configuration's ``md``."""
    from openmmgridforce_tpu_torch.mm import system_from_amber

    md = config["md"]
    return system_from_amber(topology(ligand), dtype=torch.float32,
                             hydrogen_mass=md["hydrogen_mass"],
                             constraints=md.get("constraints"),
                             device=device)


def generate(config, box, receptor_coords, receptor, device):
    """The configuration's grids of one receptor conformation, generated
    on ``device``."""
    from openmmgridforce_tpu_torch.grid import InterpolationMethod
    from openmmgridforce_tpu_torch.ops.gridgen import generate_grid

    g = config["grids"]
    counts, origin, spacing = box
    method = InterpolationMethod[GRID_METHODS[g["method"]]]
    return [generate_grid(counts, spacing, origin, gt, receptor_coords,
                          receptor.charges, receptor.sigmas,
                          receptor.epsilons, grid_cap=g["cap"],
                          oob_k=g["oob_k"],
                          compute_derivatives=g["method"] == "triquintic",
                          interp_method=method, device=device)
            for gt in g["types"]]


def pack(grids):
    """One fused table of the grids."""
    from openmmgridforce_tpu_torch.ops.packed import (combine_packed_grids,
                                                      pack_grid)

    return combine_packed_grids([pack_grid(g) for g in grids])


def binding(table, scaling, device):
    from openmmgridforce_tpu_torch.mm import GridBinding

    return GridBinding(grid=table, scaling=torch.as_tensor(
        scaling, dtype=torch.float32, device=device))


def md_runner(n_steps, config, device):
    from openmmgridforce_tpu_torch.mm import make_md_runner

    md = config["md"]
    return make_md_runner(n_steps, dt=md["dt_ps"],
                          friction=md["friction_per_ps"], device=device)


def state(x, v):
    from openmmgridforce_tpu_torch.mm import MDState

    return MDState(x, v, None)


def sampler(ligand, system, bindings, config, seed, device):
    """The replica-exchange sampler of a ladder configuration, every rung
    from the ligand's pose, genetic MC over its bonds. The configuration's
    ``ladder`` gives ``states``, ``t_min_K``, ``t_high_K`` and ``nstep_md``
    (MD steps a trial), its ``md`` the step, friction and hydrogen mass;
    ``seed`` (a whole number below 2**63) seeds the sampler's draws."""
    from openmmgridforce_tpu_torch.sampling import Sampler, SamplerConfig

    md, ladder = config["md"], config["ladder"]
    settings = SamplerConfig(
        n_states=ladder["states"], t_min=ladder["t_min_K"],
        t_high=ladder["t_high_K"], dt=md["dt_ps"],
        friction=md["friction_per_ps"],
        md_steps_per_trial=ladder["nstep_md"],
        hydrogen_mass=md["hydrogen_mass"], seed=seed)
    return Sampler(system, bindings, ligand.coords, settings,
                   bonds=[tuple(int(i) for i in b) for b in ligand.bond_idx],
                   device=device)


def while_recordings() -> int:
    """Recorded segment blocks alive that hold conditional WHILE nodes
    (the constraint solver's stop on the card)."""
    from openmmgridforce_tpu_torch.mm import graphs

    return graphs.while_recordings()


def constraint_sweeps() -> dict:
    """The constraint solvers' sweep counts since the last
    ``reset_constraint_sweeps``: {"shake", "rattle"} each a summary with
    ``calls`` and, where there were calls, ``mean_executed`` (sweeps a
    batched call ran), ``max_executed``, ``mean_sweeps`` and
    ``max_sweeps`` (a replica's own)."""
    from openmmgridforce_tpu_torch.mm.constraints import (apply_rattle,
                                                          apply_shake)

    return {"shake": apply_shake.stats.summary(),
            "rattle": apply_rattle.stats.summary()}


def reset_constraint_sweeps():
    """Zero the counts ``constraint_sweeps`` reads."""
    from openmmgridforce_tpu_torch.mm.constraints import (apply_rattle,
                                                          apply_shake)

    apply_shake.stats.reset()
    apply_rattle.stats.reset()
