"""gen_ms: the synchronised span around a receptor's generate_grid calls
(the generation kernel and, for derivative grids, the chain rules), in ms,
averaged over the traced conformations."""


def read(run):
    s = run.spans.get("generate")
    return 1e3 * sum(s) / len(s) if s else None
