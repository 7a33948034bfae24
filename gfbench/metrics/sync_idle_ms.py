"""sync_idle_ms: device-idle ms a traced conformation inside the program's
``omgf.sync.*`` spans, the host read-backs and waits on the generation and
pack path (the memory guard's reads, the packs' geometry check)."""

from gfbench import spans


def read(run):
    t, traced = run.trace, run.traced
    if t is None or not t.device_ops or not traced \
            or "receptors" not in traced \
            or not spans.has_spans(t, "omgf.gridgen"):
        return None
    return spans.idle_ms(t, spans.under(t, "omgf.sync.")) / traced[
        "receptors"]
