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

__all__ = ["Grid", "InterpolationMethod", "InvPowerMode", "resolve_device"]
