"""gen_host_ms: host ms a traced conformation inside the program's
``omgf.gridgen`` spans (each generate_grid call: the memory guard, the
atom table, the generation kernel, the chain rules of derivative grids),
on the profiler's clock, with no synchronisation added."""

from gfbench import spans


def read(run):
    return spans.per_receptor_host_ms(run, "omgf.gridgen")
