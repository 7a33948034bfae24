"""pack_host_ms: host ms a traced conformation inside the program's
``omgf.pack`` spans (pack_grid and combine_packed_grids), on the
profiler's clock, with no synchronisation added."""

from gfbench import spans


def read(run):
    return spans.per_receptor_host_ms(run, "omgf.pack")
