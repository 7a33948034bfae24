"""Checkpoints and observability. The JAX package's ``utils/cache.py`` (its
compilation cache) has no counterpart here."""

from .checkpoint import load_pytree, load_sampler, save_pytree, save_sampler
from .observe import (StateDataReporter, capture_trace, trace,
                      write_xyz_frame)

__all__ = ["StateDataReporter", "capture_trace", "load_pytree",
           "load_sampler", "save_pytree", "save_sampler", "trace",
           "write_xyz_frame"]
