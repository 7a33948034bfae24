"""The ladder kind (``traffic/bpmf.py``) on the CPU at a tiny size: 3 rungs
of the tiny complex, 8 MD steps a trial, 2 exchange attempts and 1 genetic
pair, through the program's CPU path against the plain reference in
float64; the timed path broken underneath (RATTLE skipped, an exchange
accepted against Metropolis, a genetic candidate spliced at the wrong
torsion, a rung heated past the check) makes ``correct`` false; a program
whose sampler keeps no record of its sweeps stops at set-up; the cell's
files and metrics; the readers on a traced window; the reference's own
pieces against their definitions."""

import time

import numpy as np
import pytest
import torch

from gfbench import harness, program
from gfbench import trace as tr
from gfbench.reference import constrained, ladder
from gfbench.reference import ligand as ref_ligand
from gfbench.reference.precision import Arith
from gfbench.tests.tiny import tiny_files

CELL = "bpmf-ladder21"
SEED = 12345678901
BENCH = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
NEW = ["ladder_md_ms", "mc_host_ms", "rattle_sweeps", "shake_sweeps",
       "idle_pct.ladder"]


def ladder_files():
    files = tiny_files(CELL)
    c, m = files["config"], files["mix"]
    c["ladder"].update(states=3, nstep_md=8, exchange_attempts=2,
                       gmc_pairs=1)
    c["equilibration_steps"] = 16
    m.update(job_trials=3, trace_trials=1)
    return files


def ladder_run(seconds=0.5, trace=False, seed=SEED):
    return harness.execute(CELL, seed, seconds, trace, "cpu",
                           time.perf_counter(), files=ladder_files())


def reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py").read


def test_a_sound_ladder_run_is_correct_within_the_cells_limits():
    result, checks = ladder_run()
    assert result["correct"], checks
    assert result["attempted"] >= 2 and result["failed"] == 0
    limits = harness.cell(CELL)["cell"]["limits"]
    assert set(checks) == set(limits)
    for k, c in checks.items():
        assert c["value"] <= limits[k], (k, c)
    assert set(result["metrics"]) == {"setup_s", "replica_steps_per_s",
                                      "segment_ms_p95"}


def _fault(monkeypatch, fault):
    from openmmgridforce_tpu_torch.mm import integrators
    from openmmgridforce_tpu_torch.sampling import sampler as sampler_mod

    if fault == "rattle skipped":
        monkeypatch.setattr(integrators, "apply_rattle",
                            lambda cs, x, v: (v, None))
    elif fault == "exchange against Metropolis":
        real = sampler_mod.exchange_sweep

        def accept_all(energies, betas, i, j, u):
            # every attempt accepted: u below any exp(log_ratio)
            return real(energies, betas, i, j, torch.zeros_like(u) - 1.0)

        monkeypatch.setattr(sampler_mod, "exchange_sweep", accept_all)
    elif fault == "wrong torsion":
        real = sampler_mod.Sampler._gmc_propose

        def shifted(self, positions, splice, isel, jsel, icut):
            icut = (np.asarray(icut) + 1) % len(self._zmatrix)
            return real(self, positions, splice, isel, jsel, icut)

        monkeypatch.setattr(sampler_mod.Sampler, "_gmc_propose", shifted)
    elif fault == "hot rung":
        real = sampler_mod.Sampler.run_md

        def heated(self, *args, **kw):
            real(self, *args, **kw)
            v = self.states.velocities.clone()
            v[-1] *= 10.0                    # the top rung 100 x as hot
            self.states = self.states._replace(velocities=v)

        monkeypatch.setattr(sampler_mod.Sampler, "run_md", heated)


@pytest.mark.parametrize("fault", ["rattle skipped",
                                   "exchange against Metropolis",
                                   "wrong torsion", "hot rung"])
def test_a_broken_ladder_trial_is_not_correct(monkeypatch, fault):
    _fault(monkeypatch, fault)
    result, checks = ladder_run()
    assert not result["correct"], checks
    if fault == "hot rung":
        assert result["failed"] == result["attempted"] >= 1
    else:
        assert result["failed"] == 0


def test_a_sampler_without_its_records_stops_at_set_up(monkeypatch):
    """A sampler that keeps no last_exchange / last_gmc (an older port):
    the kind stops with an error before any trial, so the run exits
    non-zero at once."""
    real = program.sampler
    started = []

    def bare(*args, **kw):
        s = real(*args, **kw)
        del s.last_exchange, s.last_gmc
        started.append(s)
        return s

    monkeypatch.setattr(program, "sampler", bare)
    with pytest.raises(RuntimeError, match="last_exchange"):
        ladder_run()
    assert started and started[0].n_exchange_attempted == 0


def test_the_ladder_control_reads_wider_than_the_program():
    files = ladder_files()
    s = files["kind"].Session(files["config"], files["mix"], SEED, "cpu")
    s.setup()
    s.run_window(0.3)
    s.release()
    sound, control = s.readings(), s.readings(control="tf32")
    for k, v in sound.items():
        if k != "decisions_flipped":
            assert control[k] > 3 * v, (k, sound, control)


def test_the_cells_files_and_metrics():
    files = harness.cell(CELL)
    assert files["mix"]["kind"] == "bpmf"
    assert files["mix"]["energy_gap_allowed_kj"] \
        == files["cell"]["limits"]["energy_gap_kj"]
    assert files["cell"]["limits"]["decisions_flipped"] == 0
    c = files["config"]
    assert c["md"]["constraints"] == "HBonds"
    assert (c["ladder"]["states"], c["ladder"]["nstep_md"],
            c["ladder"]["exchange_attempts"], c["ladder"]["gmc_pairs"]) \
        == (21, 200, 5, 2)
    assert c["grids"] == harness.cell("bspline-md-r1000")["config"]["grids"]
    assert set(harness.metric_names(BENCH, CELL, True)) == set(NEW)
    assert harness.metric_names(BENCH, CELL, False) == [
        "setup_s", "replica_steps_per_s", "segment_ms_p95"]
    for name in ("bspline-md-r1000", "triquintic-md-r1000"):
        assert not set(NEW) & set(harness.metric_names(BENCH, name, True))


def test_a_traced_run_reports_the_program_spans_and_counters():
    """On the CPU the window traces the host: the sampler's spans and the
    sweep counters read, the card's events (``ladder_md_ms``,
    ``idle_pct.ladder``) read nothing."""
    result, checks = ladder_run(trace=True)
    assert result["correct"], checks
    metrics = result["metrics"]
    assert metrics["mc_host_ms"]["value"] > 0
    assert 1 <= metrics["rattle_sweeps"]["value"] <= 100
    assert 1 <= metrics["shake_sweeps"]["value"] <= 150
    assert "ladder_md_ms" not in metrics
    assert "idle_pct.ladder" not in metrics
    assert result["device"]["busy_from"] == "profiler"


class _Run:
    def __init__(self, trace, traced):
        self.trace, self.traced = trace, traced


def test_the_event_readers_on_a_window_timed_by_events():
    """Marks of two traced trials in a 100 ms window: the md spans hold 60
    ms, every span together 80 ms."""
    marks = [("exchange", 0.0, 5e3), ("gmc", 5e3, 10e3), ("md", 10e3, 40e3),
             ("exchange", 50e3, 55e3), ("gmc", 55e3, 60e3),
             ("md", 60e3, 90e3)]
    t = tr.Trace([], [("omgf.sampler.exchange", 0.0, 4e3),
                      ("omgf.sampler.gmc", 5e3, 8e3)], (0.0, 100e3),
                 busy_from="events", marks=marks)
    run = _Run(t, {"trials": 2, "sweeps": {
        "shake": {"calls": 4, "mean_executed": 12.0},
        "rattle": {"calls": 4, "mean_executed": 99.5}}})
    assert reader("ladder_md_ms")(run) == pytest.approx(30.0)
    assert reader("idle_pct.ladder")(run) == pytest.approx(20.0)
    assert reader("mc_host_ms")(run) == pytest.approx(3.5)
    assert reader("rattle_sweeps")(run) == 99.5
    assert reader("shake_sweeps")(run) == 12.0
    t.busy_from = "profiler"
    assert reader("ladder_md_ms")(run) is None
    assert reader("idle_pct.ladder")(run) is None
    # a program without the sampler's spans: nothing to read
    bare = _Run(tr.Trace([], [], (0.0, 1.0)), {"trials": 2})
    for name in NEW:
        assert reader(name)(bare) is None
    for name in NEW:
        assert reader(name)(_Run(None, None)) is None


# ----------------------------------------------------------------------
# The reference's pieces
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_ligand():
    files = ladder_files()
    from gfbench import complex as cx
    return cx.from_config(files["config"], SEED)[0]


def test_the_reference_bat_round_trip_and_splice(tiny_ligand):
    lig = tiny_ligand
    ar = Arith("float64")
    rows, primary = ladder.zmatrix(lig, 4.0)
    assert len(rows) == lig.natom - 3
    x = torch.as_tensor(lig.coords, dtype=torch.float64)
    b, a, t = ladder.internal(x, rows, primary, ar)
    y = ladder.cartesian(x, b, a, t, rows, primary, ar)
    assert float((y - x).abs().max()) < 1e-12
    # a splice at a primary torsion turns every atom about its bond: the
    # bonds and angles stay, the torsion takes the donor's
    rng = np.random.default_rng(1)
    x2 = x + torch.as_tensor(rng.normal(0, 0.01, x.shape))
    for icut in range(len(rows)):
        for splice in (True, False):
            c = ladder.genetic_candidate(x, x2, splice, icut, rows, primary,
                                         ar)
            bc, ac, tc = ladder.internal(c, rows, primary, ar)
            _, _, t2 = ladder.internal(x2, rows, primary, ar)
            assert torch.allclose(bc, b, atol=1e-12)
            assert torch.allclose(ac, a, atol=1e-10)
            k = torch.arange(len(rows))
            pick = (k >= icut) if splice else (k == icut)
            want = torch.where(pick, t2, t)
            d = torch.remainder(tc - want + np.pi, 2 * np.pi) - np.pi
            assert float(d.abs().max()) < 1e-9, (icut, splice)


def test_the_reference_zmatrix_is_the_samplers(tiny_ligand):
    from openmmgridforce_tpu_torch.sampling import bat

    lig = tiny_ligand
    masses = ref_ligand.repartitioned_masses(lig, 4.0).astype(np.float32)
    rows, primary = ladder.zmatrix(lig, 4.0)
    want, want_primary = bat.build_zmatrix(masses, [tuple(b) for b in
                                                    lig.bond_idx])
    assert np.array_equal(rows, want)
    assert np.array_equal(primary, want_primary)


def test_the_reference_constraints_hold_to_the_arithmetic(tiny_ligand):
    lig = tiny_ligand
    pairs, lengths = constrained.hbond_constraints(lig)
    assert len(pairs) > 0
    m = ref_ligand.repartitioned_masses(lig, 4.0)
    cons = constrained.Constraints(pairs, lengths, m, Arith("float64"),
                                   "cpu")
    rng = np.random.default_rng(2)
    x = torch.as_tensor(np.stack([lig.coords] * 3))
    x_new = x + torch.as_tensor(rng.normal(0, 0.003, x.shape))
    x_c = cons.shake(x, x_new)
    assert float(cons.violation(x_c).max()) < 1e-13
    # the move lies along the constraints' directions at the start
    moved = (x_c - x_new) * torch.as_tensor(m)[:, None]
    assert float(moved.sum(-2).abs().max()) < 1e-12     # momentum kept
    v = torch.as_tensor(rng.normal(0, 1.0, x.shape))
    v_c = cons.rattle(x_c, v)
    d = cons.bond_vectors(x_c)
    assert float(cons.dot(cons.bond_vectors(v_c), d).abs().max()) < 1e-12
    assert float(((v_c - v) * torch.as_tensor(m)[:, None]).sum(-2).abs()
                 .max()) < 1e-12


def test_the_reference_ladder_and_exchange_rule():
    t = ladder.temperatures(300.0, 600.0, 21)
    assert t[0] == 300.0 and t[-1] == pytest.approx(600.0)
    assert np.allclose(t[1:] / t[:-1], 2.0 ** (1 / 20))
    beta = ladder.betas(300.0, 600.0, 3)
    # an attempt of one rung with itself pairs it with its neighbour
    perm, acc = ladder.exchange_perm([0.0, 0.0, 0.0], beta, [2, 0], [2, 0],
                                     [0.5, 0.5])
    assert perm == [2, 0, 1] and acc == [True, True]
    # the colder rung's replica far lower: a swap has log_ratio -11.7
    e = [-100.0, 0.0, 0.0]
    lr = (beta[0] - beta[1]) * -100.0
    assert lr < -10
    assert ladder.exchange_perm(e, beta, [0], [1], [0.5]) == ([0, 1, 2],
                                                               [False])
    assert ladder.exchange_perm(e, beta, [0], [1], [np.exp(lr) / 2]) == (
        [1, 0, 2], [True])
    # the hotter rung's replica lower: always taken
    assert ladder.exchange_perm([0.0, -100.0, 0.0], beta, [1], [0],
                                [0.999]) == ([1, 0, 2], [True])
    assert ladder.robust(-0.5, np.exp(-0.5) * 0.9, 0.01) is True
    assert ladder.robust(-0.5, np.exp(-0.5) * 0.9, 0.2) is None
    assert ladder.robust(31.0, None, 0.5, window=30.0) is False
    assert ladder.decide(-1.0, None) is None
