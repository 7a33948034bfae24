"""k2_roofline: the least time of the traced derivative-kernel (K2,
``gridgen_derivs_kernel``) launches over their traced time, in %: each
launch's bound is gfbench.yardstick.k2_bound_s (the FP32 operations of
DERIVS_OPS_PER_PAIR a pair at 67 TFLOP/s), for the traced conformations'
grids."""

from gfbench import yardstick


def read(run):
    t, traced = run.trace, run.traced
    if t is None or not t.device_ops or "receptors" not in traced:
        return None
    calls, seconds = t.ops("gridgen_derivs_kernel")
    if not calls:
        return None
    bound = traced["receptors"] * sum(
        yardstick.k2_bound_s(traced["counts"], traced["receptor_atoms"], gt)
        for gt in traced["grid_types"])
    return 100.0 * bound / seconds
