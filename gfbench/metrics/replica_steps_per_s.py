"""replica_steps_per_s: the replica-steps of every segment the window
completed over the window's wall time, which ends with the last segment's
host check (a download, so the card has finished). Read in the cells that
BENCHMARK.json lists for it, whose window's ``units`` are replica-steps."""


def read(run):
    w = run.window
    return w["units"] / w["seconds"]
