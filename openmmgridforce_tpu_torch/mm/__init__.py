"""Molecular mechanics: AMBER topologies, force field, system, integrators."""

from .amber import AmberTopology, load_inpcrd, load_prmtop
from .integrators import MDState
from .streamed_md import StreamedBatchMD, StreamSet
from .system import (GridBinding, System, energy_and_forces,
                     make_md_runner, potential_energy, system_from_amber)

__all__ = ["AmberTopology", "GridBinding", "MDState", "StreamSet",
           "StreamedBatchMD", "System", "energy_and_forces", "load_inpcrd",
           "load_prmtop", "make_md_runner", "potential_energy",
           "system_from_amber"]
