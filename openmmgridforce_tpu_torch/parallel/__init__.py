"""Replica ensembles."""

from .replicas import (init_replica_states, redraw_hot_velocities,
                       replica_temperatures)

__all__ = ["init_replica_states", "redraw_hot_velocities",
           "replica_temperatures"]
