"""recordings_built: segment blocks recorded in the traced MD window (the
program's span ``omgf.segment.record``: warm-up step, capture and
instantiation); 0 where every segment replays recordings made before."""

from gfbench import spans


def read(run):
    t, traced = run.trace, run.traced
    if t is None or not t.device_ops or not traced or "steps" not in traced \
            or not spans.has_spans(t, "omgf.segment"):
        return None
    lo, hi = t.window
    return float(sum(lo <= s <= hi
                     for s, _ in spans.named(t, "omgf.segment.record")))
