"""receptor_grids_s: the window's wall time over the receptor
conformations it completed, each from host coordinates to the fused table
on the card. Read in the cells that BENCHMARK.json lists for it."""


def read(run):
    w = run.window
    return w["seconds"] / w["items"]
