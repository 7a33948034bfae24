"""Molecular mechanics: AMBER topologies, force field, system, integrators."""

from .amber import AmberTopology, load_inpcrd, load_prmtop
from .integrators import (MDState, initialize_state,
                          instantaneous_temperature, kinetic_energy,
                          make_langevin_step, make_respa_langevin_step,
                          make_verlet_step, run_respa_segment, run_segment,
                          run_trajectory)
from .streamed_md import StreamedBatchMD, StreamSet
from .system import (GridBinding, System, energy_and_forces, grid_energy,
                     make_md_runner, potential_energy, system_from_amber)

__all__ = ["AmberTopology", "GridBinding", "MDState", "StreamSet",
           "StreamedBatchMD", "System", "energy_and_forces", "grid_energy",
           "initialize_state", "instantaneous_temperature", "kinetic_energy",
           "load_inpcrd", "load_prmtop", "make_langevin_step",
           "make_md_runner", "make_respa_langevin_step", "make_verlet_step",
           "potential_energy", "run_respa_segment", "run_segment",
           "run_trajectory", "system_from_amber"]
