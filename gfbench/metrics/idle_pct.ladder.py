"""idle_pct.ladder: the share of the traced ladder window in which the
card ran none of the benchmark's spans (exchange, genetic MC, MD), timed
by CUDA events (``busy_from`` "events"), in %: the host's decisions, reads
and checks between them."""


def read(run):
    t, traced = run.trace, run.traced
    if t is None or t.busy_from != "events" or not t.marks or not traced \
            or "trials" not in traced:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())
