"""ladder_md_ms: card ms a traced ladder trial inside the benchmark's span
``md`` (the MD's velocity and noise draws and the program's segment of
recorded blocks), from the CUDA events the traced window records at the
span's entry and exit (``busy_from`` "events")."""


def read(run):
    t, traced = run.trace, run.traced
    if t is None or t.busy_from != "events" or not traced \
            or "trials" not in traced:
        return None
    md = [(s, e) for name, s, e in t.marks if name == "md"]
    if not md:
        return None
    return sum(e - s for s, e in md) * 1e-3 / traced["trials"]
