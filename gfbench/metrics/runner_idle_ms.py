"""runner_idle_ms: device-idle ms a traced MD segment inside the program's
runner calls (the span ``omgf.segment``: the temperature copy, the
segment's lookup, the carry loads, the noise-block copies, the replays and
the clones), all idle time inside the span, over the traced segments."""

from gfbench import spans


def read(run):
    t, traced = run.trace, run.traced
    if t is None or not t.device_ops or not traced or "steps" not in traced:
        return None
    segments = spans.named(t, "omgf.segment")
    if not segments:
        return None
    return spans.idle_ms(t, segments) / len(segments)
