"""PyTorch/CUDA port of openmmgridforce_tpu.

The package mirrors the JAX package's layout (``grid``, ``units``,
``ops/gridgen``, ``ops/packed``, ``mm/system`` ...) on PyTorch tensors. It
imports neither ``jax`` nor ``openmmgridforce_tpu``: modules it needs from
there are kept here as copies.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :func:`resolve_device`). Hand-written kernels live in
``csrc/`` and are compiled with ``nvcc`` at first use into ``_build/``.
"""

from .device import resolve_device
from .grid import Grid, InterpolationMethod, InvPowerMode
from .ops import GridEval, evaluate_grid, grid_energy

__all__ = ["Grid", "GridEval", "InterpolationMethod", "InvPowerMode",
           "evaluate_grid", "grid_energy", "resolve_device"]
