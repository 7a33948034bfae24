"""k1_roofline: the least time of the traced values-kernel (K1,
``gridgen_values_kernel``) launches over their traced time, in %: each
launch's bound is gfbench.yardstick.k1_bound_s (FP32 operations at 67
TFLOP/s, rsqrt results at the MUFU rate of 67e12 / 16, bytes at 3.35
TB/s), for the traced conformations' grids."""

from gfbench import yardstick


def read(run):
    t, traced = run.trace, run.traced
    if t is None or not t.device_ops or "receptors" not in traced:
        return None
    calls, seconds = t.ops("gridgen_values_kernel")
    if not calls:
        return None
    bound = traced["receptors"] * sum(
        yardstick.k1_bound_s(traced["counts"], traced["receptor_atoms"], gt)
        for gt in traced["grid_types"])
    return 100.0 * bound / seconds
