"""On the card, at each MD cell's own size: the replays of a traced
window split into the four force and step terms, which with the
operations outside the replays add up to step_device_ms; each term lies
within 15% of the same term of eager steps; the window records no block.
Skipped without a card.

The eager steps run in the same process and profiler session as the
replays they are compared with, from the same states: a block of eager
steps before each traced segment and after the last. K3's time depends
on how far the replicas have spread from the pose, which grows through a
job; eager steps from the state that a 1 s window happened to end on,
in a process of their own, read the triquintic grid term 15-19% above
the replayed one on some cards (K3 22-32 us from process to process).
Each block is queued behind a kernel that holds the card until the host
has launched it, so that its operations run back to back as a replay's
nodes do, not each when its launch arrives.

Each measurement runs in a process of its own with one profiler session,
as a benchmark run has: in a process's later sessions the profiler was
seen to lose device records and the card's clock to drift from the
host's, which no split survives."""

import json
import subprocess
import sys

import pytest
import torch

from gfbench import harness, program, spans
from gfbench import trace as tr

TERMS = ("omgf.force.bonded", "omgf.force.pair", "omgf.force.grid",
         "omgf.step.integrate")
# the card's clock cycles (about 0.1 s) that it is held for while the host
# launches a block of eager steps
HOLD_CYCLES = 200_000_000


def reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py").read


def measure(cell, mode):
    """``traced``: a cell's traced window as a run has it, split;
    ``beside``: the same window with a held block of eager steps before
    each traced segment and after the last, the replays and the eager
    steps each split."""
    from openmmgridforce_tpu_torch.mm import graphs

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    run = harness.Run(harness.cell(cell), 4000000013, "cuda")
    s = run.session
    s.setup()
    s.run_window(1.0)
    window = tr.traced("cuda")
    if mode == "beside":
        block = program.md_runner(graphs.BLOCK, s.config, "cuda")

        def eager():
            with graphs.eager():
                block(s.state, s.system, [s.binding], s.temps,
                      noise=s.noise[:graphs.BLOCK])

        eager()
        mix = s.mix
        first = -(-s.window["items"] // mix["job_segments"]) \
            * mix["job_segments"]
        s._segment(first)
        torch.cuda.synchronize()
        with window:
            for index in range(first + 1, first + 1 + mix["trace_segments"]):
                torch.cuda._sleep(HOLD_CYCLES)
                eager()
                s._segment(index)
            torch.cuda._sleep(HOLD_CYCLES)
            eager()
        t, blocks = window.trace, spans.recorded_blocks()
        return {"steps": mix["trace_segments"] * mix["segment_steps"],
                "terms": spans.replay_terms(t, blocks),
                "eager_steps": (mix["trace_segments"] + 1) * graphs.BLOCK,
                "eager_terms": spans.eager_terms(t, blocks=blocks)}
    s.run_traced(run.span, window)
    run.trace = t = window.trace
    blocks = spans.recorded_blocks()
    terms = spans.replay_terms(t, blocks)
    in_replays = {p + k for serial, p in (spans.deal(t, blocks) or ())
                  for k in range(blocks[serial][0])}
    return {"steps": s.traced["steps"], "terms": terms,
            "other_s": sum(end - start for i, (_, start, end)
                           in enumerate(t.device_ops)
                           if i not in in_replays) * 1e-6,
            "metrics": {m: reader(m)(run) for m in (
                "step_device_ms", "recordings_built", "runner_idle_ms",
                "term_ms.bonded", "term_ms.pair", "term_ms.grid",
                "term_ms.integrate")}}


@pytest.fixture(scope="module",
                params=["bspline-md-r1000", "triquintic-md-r1000"])
def measured(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = {}
    for mode in ("traced", "beside"):
        p = subprocess.run([sys.executable, "-m",
                            "gfbench.tests.test_gfbench_spans_cuda",
                            request.param, mode], cwd=harness.CHECKOUT,
                           capture_output=True, text=True, timeout=900)
        assert p.returncode == 0, p.stderr[-3000:]
        out[mode] = json.loads(p.stdout.strip().splitlines()[-1])
    return out


@pytest.mark.cuda
def test_the_terms_and_the_other_operations_add_up_to_the_step(measured):
    got = measured["traced"]
    terms, m = got["terms"], got["metrics"]
    assert terms is not None and set(terms) == set(TERMS), terms
    step = m["step_device_ms"]
    total = (sum(terms.values()) + got["other_s"]) * 1e3 / got["steps"]
    assert abs(total - step) <= 0.01 * step, (total, step)
    for name in TERMS:
        term = "term_ms." + name.rsplit(".", 1)[1]
        assert m[term] == pytest.approx(terms[name] * 1e3 / got["steps"])
    assert m["recordings_built"] == 0
    assert m["runner_idle_ms"] >= 0


@pytest.mark.cuda
def test_each_term_lies_near_the_same_term_of_eager_steps(measured):
    got = measured["beside"]
    assert got["terms"] is not None and got["eager_terms"] is not None
    for name in TERMS:
        graph_ms = got["terms"][name] * 1e3 / got["steps"]
        eager_ms = got["eager_terms"][name] * 1e3 / got["eager_steps"]
        assert abs(eager_ms - graph_ms) <= 0.15 * graph_ms, (
            name, eager_ms, graph_ms)


if __name__ == "__main__":
    print(json.dumps(measure(sys.argv[1], sys.argv[2])))
