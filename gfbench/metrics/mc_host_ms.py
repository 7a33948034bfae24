"""mc_host_ms: host ms a traced ladder trial inside the program's spans
``omgf.sampler.exchange`` and ``omgf.sampler.gmc`` (the exchange and the
genetic sweeps: their launches, the host's decisions and the reads
between them), on the profiler's clock, with no synchronisation added."""

from gfbench import spans


def read(run):
    t, traced = run.trace, run.traced
    if t is None or not traced or "trials" not in traced:
        return None
    names = ("omgf.sampler.exchange", "omgf.sampler.gmc")
    if not all(spans.has_spans(t, n) for n in names):
        return None
    return sum(spans.host_ms(t, n) for n in names) / traced["trials"]
