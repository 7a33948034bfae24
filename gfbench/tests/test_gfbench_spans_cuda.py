"""On the card, at each MD cell's own size: the replays of a traced
window split into the four force and step terms, which with the
operations outside the replays add up to step_device_ms; each term lies
within 15% of the same term of a block of eager steps; the window records
no block. Skipped without a card.

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


def reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py").read


def measure(cell, mode):
    """``traced``: a cell's traced window, split; ``eager``: a block of
    eager steps after the cell's window, split by the spans it ran in."""
    from openmmgridforce_tpu_torch.mm import graphs

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    run = harness.Run(harness.cell(cell), 4000000013, "cuda")
    s = run.session
    s.setup()
    s.run_window(1.0)
    window = tr.traced("cuda")
    if mode == "eager":
        block = program.md_runner(graphs.BLOCK, s.config, "cuda")

        def eager():
            with graphs.eager():
                block(s.state, s.system, [s.binding], s.temps,
                      noise=s.noise[:graphs.BLOCK])

        eager()
        with window:
            eager()
        return {"steps": graphs.BLOCK,
                "terms": spans.eager_terms(window.trace)}
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
    for mode in ("traced", "eager"):
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
    graph, eager = measured["traced"], measured["eager"]
    assert eager["terms"] is not None
    for name in TERMS:
        graph_ms = graph["terms"][name] * 1e3 / graph["steps"]
        eager_ms = eager["terms"][name] * 1e3 / eager["steps"]
        assert abs(eager_ms - graph_ms) <= 0.15 * graph_ms, (
            name, eager_ms, graph_ms)


if __name__ == "__main__":
    print(json.dumps(measure(sys.argv[1], sys.argv[2])))
