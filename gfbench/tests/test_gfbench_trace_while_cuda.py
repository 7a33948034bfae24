"""On the card: a traced window (``gfbench.trace.traced``) over replays of
a recorded segment that holds conditional WHILE nodes, the constraint
solver's stop, at the BPMF ladder's shape: 21 replicas of the benchmark's
47-atom ligand, HBonds constraints, hydrogen mass 4, 2 fs, a geometric
300-600 K ladder, 200-step segments on the bench-bspline grids, all built
through ``gfbench.program``. Skipped without a card.

Each measurement runs in a fresh process, as a benchmark run does, after
the segment is recorded and replayed once. Two modes:

- ``profiler``: the window forced to trace the card with the profiler:
  whether the process lives, the AbsMax reductions in the trace (one a
  SHAKE or RATTLE sweep: the solvers' error norm) beside the sweeps that
  the solvers' counters say ran, and the trace's busy time beside CUDA
  events' time of the same replays;
- ``window``: the window as a run opens it, which must time the card by
  events while the recording lives, and whose busy time must agree with
  CUDA events' time of the same replays within 1%.

The events measure counts the whole of each span's interval on the
stream, idle inside it included, so it bounds the card's busy time from
above. How far above is read where the profiler is sound, on an MD cell's
own traced window (no WHILE node): ``calibrate-<cell>`` traces the card
with the profiler and records CUDA events at each of the benchmark's
spans' entry and exit, which is what the events measure reads.

    python -m gfbench.tests.test_gfbench_trace_while_cuda <mode> <processes>

runs that many fresh processes of a mode, a JSON line each and a summary
line last.
"""

import contextlib
import copy
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from gfbench import harness

MODULE = "gfbench.tests.test_gfbench_trace_while_cuda"
STATES = 21
STEPS = 200
SEGMENTS = 3
SEED = 4000000019
# sweeps a call of SHAKE runs after its WHILE node, masked: 150 % 4
SHAKE_REST = 2
SHAKE_WHILE_CAP = 148


def child(mode, seed):
    from gfbench import complex as cx
    from gfbench import program, seeds
    from gfbench import trace as tr
    from gfbench.reference import fields
    from gfbench.reference import ligand as ref_ligand

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    config = copy.deepcopy(harness.cell("bspline-md-r1000")["config"])
    config["md"].update(dt_ps=0.002, hydrogen_mass=4.0, constraints="HBonds")
    g = config["grids"]
    ligand, receptor = cx.from_config(config, seed)
    counts = tuple(g["counts"])
    box = (counts, cx.grid_box(ligand.coords, counts, g["spacing_nm"]),
           (g["spacing_nm"],) * 3)
    table = program.pack(program.generate(config, box, receptor.coords,
                                          receptor, dev))
    scaling = np.stack([fields.scalings(gt, ligand.charges, ligand.sigmas,
                                        ligand.epsilons)
                        for gt in g["types"]])
    binding = program.binding(table, scaling, dev)
    system = program.system(ligand, config, dev)

    n = ligand.natom
    temps = torch.as_tensor(300.0 * 2.0 ** (np.arange(STATES)
                                            / (STATES - 1)),
                            dtype=torch.float32, device=dev)
    masses = torch.as_tensor(ref_ligand.repartitioned_masses(ligand, 4.0),
                             dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seeds.derive(seed, "velocities", 0))
    pose = torch.as_tensor(ligand.coords, dtype=torch.float32, device=dev)
    v = torch.sqrt(ref_ligand.BOLTZ * temps[:, None, None]
                   / masses[:, None]) * torch.randn((STATES, n, 3),
                                                    generator=gen,
                                                    device=dev)
    noise = torch.empty((STEPS, STATES, n, 3), device=dev)
    run = program.md_runner(STEPS, config, dev)

    def segment(state, index):
        gen.manual_seed(seeds.derive(seed, "noise", index))
        noise.normal_(generator=gen)
        return run(state, system, [binding], temps, noise=noise)

    state = segment(program.state(pose.expand(STATES, n, 3).clone(), v), -1)
    state = segment(state, 0)
    torch.cuda.synchronize()
    recordings = program.while_recordings()
    program.reset_constraint_sweeps()
    window = tr.traced(dev, force_card=mode == "profiler")
    timed = []
    with window:
        for index in range(1, SEGMENTS + 1):
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with window.mark("segment"):
                begin.record()
                state = segment(state, index)
                end.record()
            timed.append((begin, end))
    events_s = sum(b.elapsed_time(e) for b, e in timed) * 1e-3
    sweeps = program.constraint_sweeps()
    t = window.trace
    out = {"mode": mode, "seed": seed, "while_recordings": recordings,
           "busy_from": t.busy_from, "busy_s": t.busy_s(),
           "window_s": t.window_s(), "events_s": events_s,
           "busy_over_events": t.busy_s() / events_s,
           "top_ops": t.top_ops(8), "sweeps": sweeps,
           "finite": bool(torch.isfinite(state.positions).all()),
           "device": torch.cuda.get_device_name()}
    if t.busy_from == "profiler":
        shake, rattle = sweeps["shake"], sweeps["rattle"]
        executed = {k: round(s["mean_executed"] * s["calls"])
                    for k, s in sweeps.items()}
        # every call of SHAKE runs its masked rest after the WHILE node;
        # the counter counts it only where the node stopped at its cap
        exact = shake["max_executed"] < SHAKE_WHILE_CAP
        expected = (executed["shake"] + SHAKE_REST * shake["calls"]
                    + executed["rattle"])
        seen = t.ops("AbsMaxOps")[0]
        by_name = {}
        for name, _, _ in t.device_ops:
            by_name[name[:100]] = by_name.get(name[:100], 0) + 1
        out.update({"device_ops": t.ops()[0], "absmax_seen": seen,
                    "most_launched": sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:12],
                    "sweeps_on_the_card": expected,
                    "sweeps_exact": exact,
                    "seen_over_expected": seen / expected,
                    "calls": [shake["calls"], rattle["calls"]]})
    return out


def calibrate(cell, seed):
    """An MD cell's traced window as a run has it, the card traced by the
    profiler, with CUDA events at each benchmark span's entry and exit:
    the profiler's busy time beside the events measure's."""
    from gfbench import trace as tr

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    run = harness.Run(harness.cell(cell), seed, "cuda")
    s = run.session
    s.setup()
    s.run_window(1.0)
    marks = []

    @contextlib.contextmanager
    def span(name, sync=False):
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with run.span(name, sync):
            begin.record()
            yield
            end.record()
        marks.append((begin, end))

    window = tr.traced("cuda")
    s.run_traced(span, window)
    t = window.trace
    # the spans follow one another on one stream: their union is their sum
    events_s = sum(b.elapsed_time(e) for b, e in marks) * 1e-3
    return {"mode": "calibrate", "cell": cell, "seed": seed,
            "busy_from": t.busy_from, "busy_s": t.busy_s(),
            "window_s": t.window_s(), "events_s": events_s,
            "spans": len(marks), "events_over_busy": events_s / t.busy_s(),
            "device": torch.cuda.get_device_name()}


def run_processes(mode, processes):
    """``processes`` fresh processes of ``mode``: a dict each, with the
    exit code and, where it printed one, its result."""
    rows = []
    for k in range(processes):
        p = subprocess.run([sys.executable, "-m", MODULE, "--child", mode,
                            str(SEED + k)], cwd=harness.CHECKOUT,
                           capture_output=True, text=True, timeout=600)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        row = {"rc": p.returncode}
        if lines:
            row.update(json.loads(lines[-1]))
        else:
            row["stderr"] = p.stderr[-1500:]
        rows.append(row)
    return rows


def summary(rows):
    def spread(key):
        got = [r[key] for r in rows if key in r]
        return [min(got), max(got)] if got else None

    return {"processes": len(rows),
            "died": sum(r["rc"] != 0 for r in rows),
            "exit_codes": sorted({r["rc"] for r in rows}),
            "busy_from": sorted({r.get("busy_from") for r in rows
                                 if "busy_from" in r}),
            "busy_over_events": spread("busy_over_events"),
            "events_over_busy": spread("events_over_busy"),
            "seen_over_expected": spread("seen_over_expected"),
            "sweeps_exact": all(r.get("sweeps_exact", True) for r in rows)}


@pytest.mark.cuda
def test_a_window_over_while_replays_times_the_card_by_events():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rows = run_processes("window", 3)
    for r in rows:
        assert r["rc"] == 0, r.get("stderr")
        assert r["while_recordings"] > 0
        assert r["busy_from"] == "events" and r["top_ops"] is None
        assert abs(r["busy_over_events"] - 1.0) <= 0.01, r
        assert 0.0 < r["busy_s"] <= r["window_s"] and r["finite"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["bspline-md-r1000", "triquintic-md-r1000"])
def test_the_events_measure_bounds_the_profilers_busy_time(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    (r,) = run_processes("calibrate-" + cell, 1)
    assert r["rc"] == 0, r.get("stderr")
    assert r["busy_from"] == "profiler" and r["spans"] > 0
    assert r["busy_s"] <= r["events_s"] <= r["window_s"], r


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        mode, seed = sys.argv[2], int(sys.argv[3])
        out = (calibrate(mode[len("calibrate-"):], seed)
               if mode.startswith("calibrate-") else child(mode, seed))
        print(json.dumps(out), flush=True)
    else:
        rows = run_processes(sys.argv[1], int(sys.argv[2]))
        for row in rows:
            print(json.dumps(row), flush=True)
        print(json.dumps({"summary": summary(rows)}), flush=True)
