"""pack_ms: the synchronised span around packing a receptor's grids into
the fused table (pack_grid, combine_packed_grids), in ms, averaged over
the traced conformations."""


def read(run):
    s = run.spans.get("pack")
    return 1e3 * sum(s) / len(s) if s else None
