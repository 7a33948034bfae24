"""The system under test, driven through its public entry points.

Everything the benchmark takes from ``openmmgridforce_tpu_torch`` goes
through this module: building the ligand's System, generating and packing
a receptor's grids, and the Langevin segment runner. The benchmark hands
it the complex and the window's inputs; it hands back the program's own
objects and outputs.
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
    from openmmgridforce_tpu_torch.mm import system_from_amber

    return system_from_amber(topology(ligand), dtype=torch.float32,
                             hydrogen_mass=config["md"]["hydrogen_mass"],
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

