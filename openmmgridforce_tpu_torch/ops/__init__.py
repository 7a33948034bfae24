"""Grid generation, packing, evaluation and pair kernels of the port."""

from .interpolate import GridEval, evaluate_grid, grid_energy

__all__ = ["GridEval", "evaluate_grid", "grid_energy"]
