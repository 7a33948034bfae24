"""The port's spans (``utils/observe.py``): a flag check and no
RecordFunction without a profiler session; under one, the spans of grid
generation, packing and the MD runner; and the ranges of device nodes
that spans keep while a block is captured, on the host with a stand-in
count."""

import numpy as np
import pytest
import torch

import chip_smoke
from openmmgridforce_tpu_torch.grid import InterpolationMethod
from openmmgridforce_tpu_torch.mm import (GridBinding, graphs, integrators,
                                          make_md_runner, system,
                                          system_from_amber)
from openmmgridforce_tpu_torch.ops import gridgen
from openmmgridforce_tpu_torch.ops.packed import (combine_packed_grids,
                                                  pack_grid)
from openmmgridforce_tpu_torch.parallel import init_replica_states
from openmmgridforce_tpu_torch.utils import observe

torch.set_num_threads(1)

SPACING = 0.1


@pytest.fixture(scope="module")
def complex_():
    lig, lig_crd, rec, rec_crd = chip_smoke.synthetic_complex(
        0, n_ligand=9, n_receptor=40)
    counts, origin = chip_smoke.grid_box(lig_crd, spacing=SPACING)
    return lig, lig_crd, rec, rec_crd, counts, origin


def _grids(complex_, derivatives):
    _, _, rec, rec_crd, counts, origin = complex_
    method = (InterpolationMethod.TRIQUINTIC if derivatives
              else InterpolationMethod.BSPLINE)
    return [gridgen.generate_grid(
        counts, (SPACING,) * 3, origin, gt, rec_crd, rec.charges,
        rec.sigmas, rec.epsilons, compute_derivatives=derivatives,
        interp_method=method, dtype=torch.float64, device="cpu")
        for gt in ("charge", "ljr")]


def _segment(complex_, n_steps=4):
    lig, lig_crd, *_ = complex_
    table = combine_packed_grids([pack_grid(g)
                                  for g in _grids(complex_, False)])
    scaling = torch.as_tensor(np.stack([gridgen.auto_scaling_factors(
        gt, lig.charges, lig.sigmas, lig.epsilons)
        for gt in ("charge", "ljr")]), dtype=torch.float64)
    sys_ = system_from_amber(lig, hydrogen_mass=4.0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    states = init_replica_states(gen, torch.as_tensor(lig_crd), sys_.masses,
                                 300.0, 2, device="cpu")
    run = make_md_runner(n_steps, dt=0.001, friction=5.0, device="cpu")
    return lambda: run(states, sys_, [GridBinding(table, scaling)], 300.0)


def _names(prof):
    return {e.name for e in prof.events()}


class _Counted:
    """A stand-in for torch.profiler.record_function that counts the
    ranges it is asked for."""
    made = 0

    def __init__(self, name, args=None):
        type(self).made += 1
        self.inner = _RECORD_FUNCTION(name, args)

    def __enter__(self):
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


_RECORD_FUNCTION = torch.profiler.record_function


def test_a_span_makes_no_record_function_without_a_profiler(
        complex_, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counted)
    _Counted.made = 0
    assert observe.trace("omgf.segment") is observe.trace("omgf.pack")
    with observe.trace("omgf.segment"):
        pass
    # generation, packing and the MD runner, every span on the path
    combine_packed_grids([pack_grid(g) for g in _grids(complex_, True)])
    _segment(complex_)()
    assert _Counted.made == 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with observe.trace("omgf.segment"):
            pass
    assert _Counted.made == 1
    assert "omgf.segment" in _names(prof)


def test_generation_and_packing_emit_their_spans(complex_):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        grids = _grids(complex_, True)
        combine_packed_grids([pack_grid(g) for g in grids])
    names = _names(prof)
    assert {"omgf.gridgen", "omgf.gridgen.chain_rules", "omgf.pack",
            "omgf.sync.fusable"} <= names
    # the memory guard reads the card's memory; on the host it does not run
    assert "omgf.sync.memory_guard" not in names
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _grids(complex_, False)
    names = _names(prof)
    assert "omgf.gridgen" in names
    assert "omgf.gridgen.chain_rules" not in names


@pytest.mark.parametrize("route", ["plain loop", "segment blocks"])
def test_the_md_runner_emits_its_spans(complex_, route, monkeypatch):
    if route == "segment blocks":
        # the card's block and noise bookkeeping, run on the host
        for mod in (integrators, system):
            monkeypatch.setattr(mod, "_recorded", lambda state: True)
    run = _segment(complex_)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    names = _names(prof)
    assert {"omgf.segment", "omgf.force.bonded", "omgf.force.pair",
            "omgf.force.grid"} <= names
    assert ("omgf.step.integrate" in names) == (route == "segment blocks")
    # the host records nothing and replays nothing
    assert not any(n.startswith(("omgf.replay.", "omgf.segment.record"))
                   for n in names)


def test_spans_keep_their_node_ranges_while_a_block_is_captured():
    nodes = [5]
    with observe.node_spans(lambda: nodes[0]) as spans:
        with observe.trace("omgf.step.integrate"):
            nodes[0] += 2
            with observe.trace("omgf.force.grid"):
                nodes[0] += 3
            nodes[0] += 1
        with observe.trace("omgf.step.integrate"):
            pass
    assert spans == [["omgf.step.integrate", 5, 6],
                     ["omgf.force.grid", 7, 3],
                     ["omgf.step.integrate", 11, 0]]
    # outside a capture the spans are off again
    assert observe.trace("omgf.force.grid") is observe.trace("omgf.pack")
    assert graphs._node_spans(11, spans) == (
        11, (("omgf.step.integrate", 5, 6), ("omgf.force.grid", 7, 3),
             ("omgf.step.integrate", 11, 0)))
    # a count that failed (a WHILE node) leaves the block without a split
    assert graphs._node_spans(-1, spans) is None
    assert graphs._node_spans(11, [["omgf.force.grid", -1, 4]]) is None
    # the host records no blocks
    assert observe.recorded_spans() == {}
