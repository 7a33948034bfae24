"""rattle_sweeps: the mean number of sweeps a batched RATTLE call executed
over the traced ladder trials (the program's counter
``apply_rattle.stats``, reset at the traced window's start): every rung
waits for the slowest, up to the solver's cap."""


def read(run):
    traced = run.traced
    if not traced or "sweeps" not in traced:
        return None
    return traced["sweeps"]["rattle"].get("mean_executed")
