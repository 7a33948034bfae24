"""idle_pct.md: the share of the traced MD window in which no operation
ran on the device, in %."""


def read(run):
    t = run.trace
    if t is None or not t.device_ops or "steps" not in run.traced:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())
