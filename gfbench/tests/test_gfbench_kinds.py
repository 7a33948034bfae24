"""End-to-end readers chosen by BENCHMARK.json, and the program's door for
constrained systems and the sampler, on the CPU.

BENCHMARK.json lists, under each end-to-end metric's ``workloads``, the
cells that report it; a reader reads whatever run it is handed. On
today's cells every reader reads what the readers keyed to a kind's name
read before (copied below), bit for bit."""

import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from gfbench import harness, program
from gfbench import complex as cx
from gfbench.tests.tiny import tiny_files

CELLS = ("bspline-md-r1000", "triquintic-md-r1000", "triquintic-gen",
         "bspline-gen")
BENCH = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")


def reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py").read


# the readers of the parent commit, keyed to the kind's name
def _parent_replica_steps_per_s(run):
    w = run.window
    return w["units"] / w["seconds"] if run.mix["kind"] == "md" else None


def _parent_segment_ms_p95(run):
    if run.mix["kind"] != "md":
        return None
    d = np.asarray(run.window["durations"]) * 1e3
    return float(np.percentile(d, 95))


def _parent_receptor_grids_s(run):
    w = run.window
    return w["seconds"] / w["items"] if run.mix["kind"] == "gen" else None


PARENT = {"replica_steps_per_s": _parent_replica_steps_per_s,
          "segment_ms_p95": _parent_segment_ms_p95,
          "receptor_grids_s": _parent_receptor_grids_s}


@pytest.mark.parametrize("name", CELLS)
def test_the_end_to_end_readers_read_as_before_on_todays_kinds(name):
    run = harness.Run(tiny_files(name), 12345678901, "cpu")
    run.session.setup()
    run.session.run_window(0.3)
    listed = harness.metric_names(BENCH, name, False)
    for metric, parent in PARENT.items():
        was = parent(run)
        if metric not in listed:
            # never read in this cell, as the parent read nothing here
            assert was is None, (metric, was)
            continue
        now = reader(metric)(run)
        assert type(now) is type(was) and now == was, (metric, now, was)


@pytest.mark.parametrize("listed", [True, False])
def test_a_new_kind_reports_the_metrics_its_cell_is_listed_under(
        listed, monkeypatch):
    """A cell of a kind that no reader knows by name reports
    replica_steps_per_s from its window's units and seconds where the cell
    is appended to the metric's workloads, and none where it is not;
    segment_ms_p95 and receptor_grids_s, which do not list it, stay out."""
    kind = harness.load_module(harness.ROOT / "tests" / "standin.py")
    files = {"cell": {"chips": 1, "limits": {}}, "config": {},
             "mix": {"kind": "standin"}, "kind": kind}
    bench = copy.deepcopy(BENCH)
    if listed:
        next(m for m in bench["end_to_end"]
             if m["name"] == "replica_steps_per_s")["workloads"].append(
                 "standin-cell")
    monkeypatch.setattr(harness, "load_json", lambda path: bench)
    result, _ = harness.execute("standin-cell", 1, 0.0, False, "cpu",
                                time.perf_counter(), files=files)
    metrics = result["metrics"]
    if listed:
        assert metrics["replica_steps_per_s"]["value"] == 500.0
    else:
        assert "replica_steps_per_s" not in metrics
    assert "segment_ms_p95" not in metrics
    assert "receptor_grids_s" not in metrics
    assert "setup_s" in metrics


def _same(a, b):
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            _same(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
    return a == b


def test_the_system_takes_its_constraints_from_the_configuration():
    from openmmgridforce_tpu_torch.mm import system_from_amber

    config = harness.cell("bspline-md-r1000")["config"]
    ligand, _ = cx.from_config(config, 12345678901)
    top = program.topology(ligand)
    plain = program.system(ligand, config, "cpu")
    assert plain.constraints is None
    assert _same(plain, system_from_amber(top, dtype=torch.float32,
                                          hydrogen_mass=4.0, device="cpu"))
    config["md"]["constraints"] = "HBonds"
    held = program.system(ligand, config, "cpu")
    assert _same(held, system_from_amber(top, dtype=torch.float32,
                                         hydrogen_mass=4.0,
                                         constraints="HBonds",
                                         device="cpu"))
    hydrogens = {i for i, e in enumerate(ligand.elements) if e == "H"}
    h_bonds = sum(1 for i, j in ligand.bond_idx
                  if i in hydrogens or j in hydrogens)
    assert held.constraints.num_constraints == h_bonds > 0
    assert held.bond_idx.shape[0] == plain.bond_idx.shape[0] - h_bonds


def test_the_sampler_is_built_from_a_ladder_configuration():
    """program.sampler on the tiny bspline grids: a 4-rung 300-600 K
    ladder of the HBonds-constrained ligand at 2 fs runs a trial of MD,
    exchange and genetic MC; no recording holds a WHILE node on the
    CPU."""
    files = tiny_files("bspline-md-r1000")
    config = files["config"]
    config["md"].update(dt_ps=0.002, constraints="HBonds")
    config["ladder"] = {"states": 4, "t_min_K": 300.0, "t_high_K": 600.0,
                        "nstep_md": 4}
    run = harness.Run(files, 12345678901, "cpu")
    s = run.session
    s.setup()
    system = program.system(s.ligand, config, "cpu")
    sampler = program.sampler(s.ligand, system, [s.binding], config, 7,
                              "cpu")
    assert np.allclose(sampler.temperatures, 300.0 * 2.0 ** (np.arange(4)
                                                             / 3))
    program.reset_constraint_sweeps()
    sampler.run(1, n_exchange_per_trial=2, n_gmc_per_trial=1)
    assert sampler.n_exchange_attempted == 2
    assert torch.isfinite(sampler.states.positions).all()
    assert program.constraint_sweeps()["rattle"]["calls"] > 0
    assert program.while_recordings() == 0
