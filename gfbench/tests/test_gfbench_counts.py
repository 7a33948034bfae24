"""The yardstick's counts against hand-counted small cases, and the trace's
reduction against hand-made timelines."""

import pytest
import torch

from gfbench import yardstick
from gfbench.trace import Trace


def test_cells_inside_counts_by_hand():
    # a 3 x 3 x 3 box of unit spacing: 2 x 2 x 2 cells, (i * 2 + j) * 2 + k
    pos = torch.tensor([[0.5, 0.5, 0.5],      # cell (0, 0, 0) = 0
                        [1.5, 0.5, 0.5],      # (1, 0, 0) = 4
                        [2.0, 2.0, 2.0],      # upper corner: last cell, 7
                        [0.0, 1.0, 1.9],      # (0, 1, 1) = 3
                        [-0.1, 0.5, 0.5],     # outside
                        [0.5, 2.1, 0.5]])     # outside
    cells = yardstick.cells_inside(pos, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                   (3, 3, 3))
    assert cells.tolist() == [0, 4, 7, 3]


def test_k3_bound_counts_distinct_rows_and_bytes_by_hand():
    # 2 replicas x 3 atoms; inside: cells 0, 0, 7 | 0, 4, outside
    pos = torch.tensor([[[0.2, 0.2, 0.2], [0.7, 0.1, 0.9], [1.5, 1.5, 1.5]],
                        [[0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [3.0, 0.0, 0.0]]])
    b = yardstick.k3_bound(pos, (0.0,) * 3, (1.0,) * 3, (3, 3, 3), degree=4,
                           n_grids=3, itemsize=4)
    assert b["atoms_inside"] == 5
    assert b["distinct_rows"] == 3
    row = 3 * 4 ** 3 * 4
    # positions in and forces out (18 each), scalings [3 grids, 3 atoms],
    # one energy an atom (6)
    assert b["bytes"] == 3 * row + (18 * 2 + 9 + 6) * 4
    assert b["flops"] == 5 * (3 * (4 * 64 + 8 * 16 + 20) + 3 * 16)
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx(b["bytes"] / 3.35e12)


def test_generation_bounds_count_pairs_by_hand():
    counts, atoms = (10, 10, 10), 100
    pairs, columns = 1000 * 100, 10 * 10 * 100
    # charge: 7 FP32 operations a pair + 5 a column-atom at 67 TFLOP/s,
    # against one MUFU result a pair at 67e12 / 16
    fp32 = (pairs * 7 + columns * 5) / 67e12
    mufu = pairs / (67e12 / 16)
    assert yardstick.k1_bound_s(counts, atoms, "charge") == pytest.approx(
        max(fp32, mufu))
    assert yardstick.k1_bound_s(counts, atoms, "charge") == pytest.approx(
        mufu)
    assert yardstick.k2_bound_s(counts, atoms, "ljr") == pytest.approx(
        pairs * 149 / 67e12)


def _trace():
    # device operations (us): two overlapping, one alone, one past the
    # window's end; host operations cover the gaps
    dev = [("k_a", 10.0, 30.0), ("k_b", 20.0, 40.0), ("k_c", 60.0, 70.0),
           ("k_a", 95.0, 120.0)]
    host = [("gfbench.segment", 0.0, 100.0), ("cudaGraphLaunch", 5.0, 12.0),
            ("aten::copy_", 41.0, 58.0)]
    return Trace(dev, host, (0.0, 100.0))


def test_busy_time_is_the_union_of_intervals():
    t = _trace()
    assert t.busy_s() == pytest.approx((30 + 10 + 5) * 1e-6)
    assert t.window_s() == pytest.approx(100e-6)
    assert t.ops("k_a") == (2, pytest.approx(45e-6))
    assert t.ops()[0] == 4


def test_idle_gaps_are_named_by_the_host_operation_running():
    gaps = dict(_trace().idle_gaps())
    # each gap begins while only the segment span runs: [0, 10) before
    # cudaGraphLaunch starts, [40, 60) before aten::copy_ starts, [70, 95)
    assert gaps == {"gfbench.segment": pytest.approx((10 + 20 + 25) * 1e-6)}


def _events_trace():
    """The card timed by events: the benchmark's spans' intervals on the
    card's clock (two overlapping, one past the window's end), no device
    operation traced."""
    marks = [("gfbench.segment", 10.0, 40.0), ("gfbench.segment", 30.0, 60.0),
             ("gfbench.segment", 80.0, 120.0)]
    host = [("gfbench.segment", 0.0, 100.0), ("aten::copy_", 55.0, 75.0)]
    return Trace([], host, (0.0, 100.0), busy_from="events", marks=marks)


def test_an_events_window_is_busy_in_the_union_of_its_marks():
    t = _events_trace()
    assert t.busy_s() == pytest.approx((50 + 20) * 1e-6)
    assert t.ops() is None and t.ops("k") is None
    assert t.top_ops() is None
    # [0, 10) and [60, 80): the first begins under the segment span alone,
    # the second as aten::copy_ runs
    assert dict(t.idle_gaps()) == {
        "gfbench.segment": pytest.approx(10e-6),
        "aten::copy_": pytest.approx(20e-6)}


@pytest.mark.parametrize("name", ["step_device_ms", "step_kernels",
                                  "k3_roofline", "idle_pct.md",
                                  "term_ms.grid", "runner_idle_ms"])
def test_readers_of_device_operations_read_nothing_in_an_events_window(name):
    import types

    from gfbench import harness

    run = types.SimpleNamespace(trace=_events_trace(),
                                traced={"steps": 10, "positions": []})
    assert harness.load_module(
        harness.ROOT / "metrics" / f"{name}.py").read(run) is None


def test_a_window_on_the_cpu_marks_nothing():
    from gfbench import trace as tr

    window = tr.traced("cpu")
    with window:
        with window.mark("x"):
            pass
    assert window.trace.busy_from == "profiler"
    assert window.trace.marks == []
