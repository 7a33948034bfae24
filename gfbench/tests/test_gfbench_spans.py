"""gfbench.spans and the span readers on hand-built traces, against
answers counted by hand; and on the CPU, where the device is not traced,
every span reader returns None."""

import types

import pytest

from gfbench import harness, spans
from gfbench.trace import Trace
from gfbench.tests.tiny import tiny_run

NEW = ("term_ms.bonded", "term_ms.pair", "term_ms.grid",
       "term_ms.integrate", "runner_idle_ms", "recordings_built",
       "gen_host_ms", "pack_host_ms", "chain_rules_ms", "sync_idle_ms")


def trace(device, host, window=(0.0, 100.0)):
    return Trace(sorted(device, key=lambda t: t[1]),
                 sorted(host, key=lambda t: t[1]), window)


def reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py").read


# busy [10, 20], [30, 50], [70, 80]; spans nested and overlapping
IDLE = trace([("k", 10, 20), ("k", 30, 40), ("k", 35, 50), ("k", 70, 80)],
             [("omgf.a", 5, 45), ("omgf.a", 15, 25), ("omgf.b", 40, 75),
              ("aten::add", 0, 90)])


def test_idle_inside_nested_and_overlapping_spans():
    # the spans' union is [5, 75]: idle 5-10, 20-30, 50-70
    assert spans.idle_ms(IDLE, spans.under(IDLE, "omgf.")) == \
        pytest.approx(0.035)
    # "omgf.a" alone, [5, 45]: idle 5-10, 20-30
    assert spans.idle_ms(IDLE, spans.named(IDLE, "omgf.a")) == \
        pytest.approx(0.015)
    assert spans.host_ms(IDLE, "omgf.a") == pytest.approx(0.040)
    assert spans.idle_ms(IDLE, []) == 0.0


def test_spans_are_clipped_to_the_window():
    t = trace([("k", 10, 20)], [("omgf.a", -50, 30)], window=(0.0, 40.0))
    assert spans.host_ms(t, "omgf.a") == pytest.approx(0.030)
    assert spans.idle_ms(t, spans.named(t, "omgf.a")) == pytest.approx(0.020)


# a block of three device nodes: the step's span over all three, the grid
# term's nested in it over the second
BLOCKS = {7: (3, (("omgf.step.integrate", 0, 3), ("omgf.force.grid", 1, 1)))}


def replays(extra=(), drop=None):
    """A copy, a replay, a kernel launch and a second replay; times in
    units of 100 us, so that no operation lies within the clock's
    tolerance of a launch before its own."""
    host = [("cudaMemcpyAsync", 0, 1), ("omgf.replay.7", 2, 6),
            ("cudaGraphLaunch", 3, 5), ("cudaLaunchKernel", 7, 8),
            ("omgf.replay.7", 9, 12), ("cudaGraphLaunch", 10, 11),
            ("cudaStreamSynchronize", 12, 30)]
    device = [("Memcpy DtoD (Device -> Device)", 2, 4),
              ("a", 5, 6), ("b", 6, 9), ("c", 9, 10),
              ("eager", 11, 12),
              ("a", 13, 14), ("b", 14, 16), ("c", 16, 17), *extra]
    if drop is not None:
        del device[drop]
    return trace([(n, 100 * s, 100 * e) for n, s, e in device],
                 [(n, 100 * s, 100 * e) for n, s, e in host],
                 window=(0.0, 10000.0))


def test_replays_align_and_split_into_their_spans():
    t = replays()
    assert spans.deal(t, BLOCKS) == [(7, 1), (7, 5)]
    terms = spans.replay_terms(t, BLOCKS)
    # the step's own nodes a and c, twice; the grid term's b, twice
    assert terms == {"omgf.step.integrate": pytest.approx(4e-4),
                     "omgf.force.grid": pytest.approx(5e-4)}


def test_operations_missed_at_the_profile_start_leave_their_launches_out():
    """The profiler can miss the first launches' operations: the copy's
    here. Dealt from the end, the replays are whole; a replay among the
    missed launches leaves no split."""
    t = replays(drop=0)
    assert spans.deal(t, BLOCKS) == [(7, 0), (7, 4)]
    t = replays()
    missed = Trace(t.device_ops[4:], t.host_ops, t.window)
    assert spans.deal(missed, BLOCKS) is None
    # an operation from before the window is not the window's
    early = Trace([("k", -300, -200)] + t.device_ops, t.host_ops, t.window)
    assert spans.deal(early, BLOCKS) == [(7, 2), (7, 6)]
    # the last launch's operation missed at the end
    late = sorted(t.host_ops + [("cudaLaunchKernel", 1800, 1850)],
                  key=lambda h: h[1])
    assert spans.deal(Trace(t.device_ops, late, t.window), BLOCKS) == \
        [(7, 1), (7, 5)]


@pytest.mark.parametrize("case", ["one too many", "one too few"])
def test_a_replay_off_by_one_operation_splits_into_none(case):
    t = (replays(extra=[("d", 17, 18)]) if case == "one too many"
         else replays(drop=2))
    assert spans.deal(t, BLOCKS) is None
    assert spans.replay_terms(t, BLOCKS) is None


def test_a_replay_of_a_block_without_a_split_is_none():
    assert spans.deal(replays(), {7: None}) is None
    assert spans.deal(replays(), {8: BLOCKS[7]}) is None


def test_a_graph_launch_outside_a_replay_span_is_none():
    t = replays()
    host = [h for h in t.host_ops if h[0] != "omgf.replay.7"]
    assert spans.deal(Trace(t.device_ops, host, t.window), BLOCKS) is None


def test_an_operation_before_its_launch_is_none():
    t = replays()
    host = [(n, s + 1000 if n == "cudaLaunchKernel" else s,
             e + 1000 if n == "cudaLaunchKernel" else e)
            for n, s, e in t.host_ops]
    assert spans.deal(Trace(t.device_ops, sorted(host, key=lambda h: h[1]),
                            t.window), BLOCKS) is None


def card_like(offset, late=False):
    """A window as the card gives it, in us: where the device is idle a
    launch's operation starts 5 us after it, and the eager kernel
    launched during the first replay queues behind it; the device's clock
    lies ``offset`` us behind the host's. ``late``: that kernel's launch
    moved to 79 us after its operation started."""
    kernel = (1350, 1357) if late else (1255, 1262)
    host = [("cudaLaunchKernel", 1000, 1010), ("cudaMemcpyAsync", 1100, 1120),
            ("omgf.replay.7", 1200, 1300), ("cudaGraphLaunch", 1210, 1250),
            ("cudaLaunchKernel", *kernel), ("omgf.replay.7", 1400, 1500),
            ("cudaGraphLaunch", 1410, 1450),
            ("cudaStreamSynchronize", 1450, 1600)]
    device = [("k", 1005, 1040), ("Memcpy HtoD (Pageable -> Device)",
                                  1105, 1107),
              ("a", 1215, 1230), ("b", 1231, 1260), ("c", 1261, 1270),
              ("eager", 1271, 1280),
              ("a", 1415, 1430), ("b", 1431, 1460), ("c", 1461, 1470)]
    return trace([(n, s - offset, e - offset) for n, s, e in device], host,
                 window=(0.0, 5000.0))


@pytest.mark.parametrize("offset", [93.0, 824.0])
def test_a_window_behind_the_host_clock_splits_as_one_at_none(offset):
    """The device's clock behind the host's by more than SKEW_US (as the
    card gave at a window's start): the offset is fitted from the idle
    launches' least lead, and the window splits as at no offset."""
    at_zero = card_like(0.0)
    assert spans.deal(at_zero, BLOCKS) == [(7, 2), (7, 6)]
    t = card_like(offset)
    assert spans.deal(t, BLOCKS) == spans.deal(at_zero, BLOCKS)
    assert spans.replay_terms(t, BLOCKS) == \
        spans.replay_terms(at_zero, BLOCKS)


@pytest.mark.parametrize("offset", [0.0, 93.0, 824.0])
def test_an_operation_before_its_launch_is_none_at_any_offset(offset):
    """The queued kernel's operation 79 us before its launch: the fitted
    offset comes from the launches that found the device idle, so the
    operation still lies before its launch."""
    assert spans.deal(card_like(offset, late=True), BLOCKS) is None


@pytest.mark.parametrize("offset", [0.0, 824.0])
def test_eager_operations_missed_at_the_start_split_into_none(offset):
    """Five eager kernels, the device idle at each, its clock behind the
    host's; the profiler missed the first operation. Dealt from the
    start, every launch would take the next launch's operation, which
    lies after it: no offset is fitted where an operation was missed."""
    host = [("omgf.force.grid", 900, 2000)] + [
        ("cudaLaunchKernel", 1000 + 100 * k, 1010 + 100 * k)
        for k in range(5)]
    device = [(f"k{k}", 1005 + 100 * k - offset, 1050 + 100 * k - offset)
              for k in range(1, 5)]
    assert spans.eager_terms(trace(device, host, window=(0.0, 5000.0))) \
        is None


def test_a_driver_call_inside_a_runtime_call_is_one_launch():
    t = replays()
    host = sorted(t.host_ops + [("cuLaunchKernel", 720, 780)],
                  key=lambda h: h[1])
    assert spans.deal(Trace(t.device_ops, host, t.window), BLOCKS) == \
        [(7, 1), (7, 5)]


def test_eager_launches_take_the_innermost_span_at_their_launch():
    device = [("k", 2, 4), ("k", 5, 8), ("Memcpy HtoD", 13, 14)]
    host = [("omgf.step.integrate", 0, 20), ("cudaLaunchKernel", 1, 2),
            ("omgf.force.grid", 3, 10), ("cudaLaunchKernel", 4, 5),
            ("cudaMemcpyAsync", 12, 13), ("omgf.other", 30, 40)]

    def scaled(host):
        return trace([(n, 100 * s, 100 * e) for n, s, e in device],
                     [(n, 100 * s, 100 * e) for n, s, e in host],
                     window=(0.0, 10000.0))

    assert spans.eager_terms(scaled(host)) == {
        "omgf.step.integrate": pytest.approx(3e-4),
        "omgf.force.grid": pytest.approx(3e-4)}
    # a launch amid the others with no operation of its own: no split
    host = host + [("cudaLaunchKernel", 10.5, 10.8)]
    assert spans.eager_terms(scaled(host)) is None


def test_eager_launches_beside_replays_split_without_the_replays():
    """The copy and the kernel launched between the two replays, the
    kernel inside the pair term's span: each eager operation goes to the
    span it was launched in, and the replays' nodes to none; without the
    blocks the replays cannot be dealt."""
    t = replays()
    host = sorted(t.host_ops + [("omgf.force.pair", 650, 850)],
                  key=lambda h: h[1])
    t = Trace(t.device_ops, host, t.window)
    assert spans.eager_terms(t, blocks=BLOCKS) == {
        None: pytest.approx(2e-4), "omgf.force.pair": pytest.approx(1e-4)}
    assert spans.replay_terms(t, BLOCKS) == spans.replay_terms(replays(),
                                                              BLOCKS)
    assert spans.eager_terms(t) is None


def test_the_term_readers_read_ms_a_step(monkeypatch):
    monkeypatch.setattr(spans, "recorded_blocks", lambda: BLOCKS)
    run = types.SimpleNamespace(trace=replays(), traced={"steps": 2})
    assert reader("term_ms.grid")(run) == pytest.approx(0.25)
    assert reader("term_ms.integrate")(run) == pytest.approx(0.2)
    # no span of the pair term in any block: nothing to read
    assert reader("term_ms.pair")(run) is None
    monkeypatch.setattr(spans, "recorded_blocks", lambda: None)
    assert reader("term_ms.grid")(run) is None


def test_the_segment_readers():
    t = trace([("k", 10, 20), ("k", 60, 90)],
              [("omgf.segment", 5, 50), ("omgf.segment", 55, 95),
               ("omgf.segment.record", 56, 58)])
    run = types.SimpleNamespace(trace=t, traced={"steps": 200})
    # idle 5-10 and 20-50 in the first, 55-60 and 90-95 in the second
    assert reader("runner_idle_ms")(run) == pytest.approx(0.045 / 2)
    assert reader("recordings_built")(run) == 1.0
    bare = types.SimpleNamespace(trace=trace(t.device_ops, []),
                                 traced={"steps": 200})
    assert reader("runner_idle_ms")(bare) is None
    assert reader("recordings_built")(bare) is None


def test_the_generation_readers():
    t = trace([("k", 10, 20), ("k", 40, 60)],
              [("omgf.gridgen", 0, 30), ("omgf.gridgen.chain_rules", 12, 28),
               ("omgf.sync.memory_guard", 1, 5), ("omgf.pack", 35, 70),
               ("omgf.sync.fusable", 60, 66), ("omgf.gridgen", 80, 90)])
    run = types.SimpleNamespace(trace=t, traced={"receptors": 2})
    assert reader("gen_host_ms")(run) == pytest.approx(0.040 / 2)
    assert reader("pack_host_ms")(run) == pytest.approx(0.035 / 2)
    assert reader("chain_rules_ms")(run) == pytest.approx(0.016 / 2)
    # idle 1-5 and 60-66
    assert reader("sync_idle_ms")(run) == pytest.approx(0.010 / 2)
    bare = types.SimpleNamespace(trace=trace(t.device_ops, []),
                                 traced={"receptors": 2})
    assert all(reader(n)(bare) is None
               for n in ("gen_host_ms", "pack_host_ms", "chain_rules_ms",
                         "sync_idle_ms"))


@pytest.mark.parametrize("name", ["bspline-md-r1000", "triquintic-gen"])
def test_the_span_readers_return_none_on_a_cpu_run(name):
    result, _ = tiny_run(name, trace=True)
    assert not set(NEW) & set(result["metrics"])
    for m in NEW:
        assert harness.load_module(
            harness.ROOT / "metrics" / f"{m}.py").read is not None
