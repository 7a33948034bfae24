"""A cell's files cut to a size the CPU runs in seconds, for the tests:
300 receptor atoms, a 31 x 33 x 31 box at 0.05 nm, a few replicas and
steps, a few sampled points."""

from __future__ import annotations

import copy

from gfbench import harness


def tiny_files(name: str, **mix) -> dict:
    files = dict(harness.cell(name))
    c, m = copy.deepcopy(files["config"]), copy.deepcopy(files["mix"])
    c["complex"]["receptor_atoms"] = 300
    c["grids"]["counts"] = [31, 33, 31]
    c["grids"]["spacing_nm"] = 0.05
    if m["kind"] == "md":
        m.update(replicas=8, segment_steps=20, warmup_steps=4,
                 check_replicas=8, trace_segments=1)
    else:
        m.update(check_points=128, trace_receptors=1)
    m.update(mix)
    files["config"], files["mix"] = c, m
    return files


def tiny_run(name, seed=12345678901, seconds=0.3, trace=False, device="cpu",
             **mix):
    import time

    return harness.execute(name, seed, seconds, trace, device,
                           time.perf_counter(), files=tiny_files(name, **mix))
