"""step_kernels: the device operations (kernels, copies, fills) in the
traced MD window over the window's steps."""


def read(run):
    t, traced = run.trace, run.traced
    if t is None or not t.device_ops or "steps" not in traced:
        return None
    return t.ops()[0] / traced["steps"]
