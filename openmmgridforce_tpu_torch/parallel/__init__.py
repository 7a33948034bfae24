"""Replica ensembles and scale-out over ``torch.distributed``: a named
mesh of ranks, x-slab grid generation and sharded packed grids (the sp
axis), replicas split over ranks (the dp axis), and the distributed
screen."""

from . import distributed
from .mesh import Mesh
from .replicas import (init_replica_states, make_ensemble_runner,
                       redraw_hot_velocities, replica_mesh, replica_noise,
                       replica_rows, replica_temperatures,
                       shard_replica_states)
from .sharded_grid import (ShardedPackedGrid, evaluate_sharded,
                           make_sharded_grid_eval, make_sharded_md_runner,
                           pack_sharded, shard_packed_grid)
from .sharded_gridgen import GridSlab, generate_grid_sharded

__all__ = ["GridSlab", "Mesh", "ShardedPackedGrid", "distributed",
           "evaluate_sharded", "generate_grid_sharded", "init_replica_states",
           "make_ensemble_runner", "make_sharded_grid_eval",
           "make_sharded_md_runner", "pack_sharded", "redraw_hot_velocities",
           "replica_mesh", "replica_noise", "replica_rows",
           "replica_temperatures", "shard_packed_grid",
           "shard_replica_states"]
