"""k3_roofline: the least time of one call of the evaluation kernel K3
(``packed_eval_kernel``) over its mean traced time a call, in %. The least
time is gfbench.yardstick.k3_bound's, from the traced window's positions
(at the start of each of its segments and at its end, averaged) and the
table's geometry, against the published peaks of an H100 SXM at 700 W."""

from gfbench import yardstick


def read(run):
    t, traced = run.trace, run.traced
    if t is None or not t.device_ops or "positions" not in traced:
        return None
    calls, seconds = t.ops("packed_eval_kernel")
    if not calls:
        return None
    g = traced["table"]
    bound = sum(yardstick.k3_bound(x, g["origin"], g["spacing"], g["counts"],
                                   g["degree"], g["n_grids"],
                                   g["itemsize"])["bound_s"]
                for x in traced["positions"]) / len(traced["positions"])
    return 100.0 * bound / (seconds / calls)
