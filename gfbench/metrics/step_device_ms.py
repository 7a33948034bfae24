"""step_device_ms: the union of the device's operation intervals in the
traced MD window, in ms, over the window's steps."""


def read(run):
    t, traced = run.trace, run.traced
    if t is None or not t.device_ops or "steps" not in traced:
        return None
    return t.busy_s() * 1e3 / traced["steps"]
