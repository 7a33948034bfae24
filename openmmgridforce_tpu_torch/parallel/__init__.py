"""Replica ensembles."""

from .replicas import init_replica_states, replica_temperatures

__all__ = ["init_replica_states", "replica_temperatures"]
