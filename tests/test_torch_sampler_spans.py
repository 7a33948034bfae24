"""The sampler's spans and counters on the CPU: under a profiler session a
trial emits ``omgf.sampler.*``, ``omgf.sync.exchange`` / ``.gmc`` and the
constraint solver's ``omgf.constraint.shake`` / ``.rattle``; the spans add
no operation and no read to the host (the same ATen operations, the same
answer, with and without a session); ``last_exchange`` / ``last_gmc`` hold
what the sweeps read, drew and decided, and ``n_gmc_batches`` counts the
proposal batches; the genetic decision keeps its windows and its draws."""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from openmmgridforce_tpu_torch.grid import InterpolationMethod
from openmmgridforce_tpu_torch.mm import GridBinding, system_from_amber
from openmmgridforce_tpu_torch.ops import gridgen, packed
from openmmgridforce_tpu_torch.sampling import Sampler, SamplerConfig

torch.set_num_threads(1)

SPACING = 0.1
GRID_TYPES = ("charge", "ljr", "lja")
SPANS = {"omgf.sampler.exchange", "omgf.sampler.gmc",
         "omgf.sampler.gmc.propose", "omgf.sampler.md",
         "omgf.sync.exchange", "omgf.sync.gmc", "omgf.constraint.shake",
         "omgf.constraint.rattle"}


@pytest.fixture(scope="module")
def ladder():
    """A 12-atom ligand with HBonds on fused B-spline grids (0.1 nm) from
    60 receptor atoms, in float64."""
    lig, x, rec, rec_x = chip_smoke.synthetic_complex(
        2, n_ligand=12, n_receptor=60, gap=0.5)
    lo = x.min(0) - 0.5
    counts = tuple(int(c) + 1 for c in np.ceil((x.max(0) + 0.5 - lo)
                                               / SPACING))
    grids = [gridgen.generate_grid(
        counts, (SPACING,) * 3, lo, gt, rec_x, rec.charges, rec.sigmas,
        rec.epsilons, interp_method=InterpolationMethod.BSPLINE,
        dtype=torch.float64, device="cpu") for gt in GRID_TYPES]
    scaling = torch.as_tensor(np.stack([gridgen.auto_scaling_factors(
        gt, lig.charges, lig.sigmas, lig.epsilons) for gt in GRID_TYPES]))
    binding = GridBinding(packed.pack_grids_fused(grids, device="cpu"),
                          scaling)
    sys_ = system_from_amber(lig, dtype=torch.float64, hydrogen_mass=4.0,
                             constraints="HBonds", device="cpu")
    return sys_, binding, x, [tuple(b) for b in lig.bond_idx]


def _sampler(ladder, n_states=3, seed=5):
    sys_, binding, x, bonds = ladder
    config = SamplerConfig(n_states=n_states, t_min=300.0, t_high=600.0,
                           dt=0.002, friction=5.0, md_steps_per_trial=4,
                           seed=seed)
    return Sampler(sys_, [binding], x, config, bonds=bonds, device="cpu")


def _trial(s):
    s.run(1, n_exchange_per_trial=2, n_gmc_per_trial=2)


class _Ops(TorchDispatchMode):
    """The ATen operations run inside, by name (the profiler's own
    record-function operations left out)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if not name.startswith("profiler."):
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


def test_a_trial_emits_the_sampler_spans_under_a_profiler(ladder):
    s = _sampler(ladder)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _trial(s)
    names = {e.name for e in prof.events()}
    assert SPANS <= names, SPANS - names


def test_the_spans_add_no_operation_and_no_host_read(ladder):
    """Two samplers of one seed run a trial, one under a profiler session:
    the same ATen operations in the same order (so the same reads to the
    host, ``aten._local_scalar_dense``), and the same ladder after it. A
    trial first fills the caches a first call builds."""
    _trial(_sampler(ladder))
    runs = []
    for profiled in (False, True):
        s = _sampler(ladder)
        ops = _Ops()
        session = (torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
            if profiled else None)
        if session is not None:
            session.__enter__()
        try:
            with ops:
                _trial(s)
        finally:
            if session is not None:
                session.__exit__(None, None, None)
        runs.append((ops.ops, s.states.positions))
    (plain, x_plain), (traced, x_traced) = runs
    assert plain == traced
    assert plain.count("aten._local_scalar_dense.default") > 0
    assert torch.equal(x_plain, x_traced)


def test_the_sweeps_keep_what_they_read_drew_and_decided(ladder):
    s = _sampler(ladder, n_states=4, seed=11)
    s.run_md(8)
    for _ in range(3):
        before = s.states.positions
        accepted = s.replica_exchange_sweep(3)
        ex = s.last_exchange
        assert torch.equal(s.states.positions, before[ex["perm"]])
        assert ex["i"].shape == ex["j"].shape == ex["u"].shape == (3,)
        assert torch.equal(ex["energies"], s._energies(before))

        start = s.states.positions
        counts = (s.n_gmc_attempted, s.n_gmc_accepted, s.n_gmc_batches)
        s.genetic_sweep(2)
        gmc = s.last_gmc
        assert len(gmc["moves"]) == 4
        assert len(gmc["decisions"]) == s.n_gmc_attempted - counts[0] == 4
        assert sum(d[3] for d in gmc["decisions"]) == (s.n_gmc_accepted
                                                       - counts[1])
        assert len(gmc["proposals"]) == s.n_gmc_batches - counts[2] >= 1
        # each decision from the energies of its batch and of the ladder
        energies = gmc["energies"].copy()
        x = start.clone()
        for move, log_ratio, u, ok in gmc["decisions"]:
            splice, low, high, icut = gmc["moves"][move]
            first, cands, e_new = max(
                (p for p in gmc["proposals"] if p[0] <= move),
                key=lambda p: p[0])
            assert log_ratio == pytest.approx(
                -s.betas[low] * (e_new[move] - energies[low]), rel=1e-12)
            assert (u is None) == (not log_ratio < 0)
            if ok:
                energies[low] = e_new[move]
                x[low] = cands[move]
        assert torch.equal(x, s.states.positions)
        s.run_md(4)
    assert accepted >= 0


def _jax_accept(rng, log_ratio, splice):
    """The genetic decision as one expression, the JAX package's form
    (`openmmgridforce_tpu/sampling/sampler.py`)."""
    return (0 <= log_ratio < (30 if splice else 50)
            or (log_ratio < 0 and rng.random() < np.exp(log_ratio)))


@pytest.mark.parametrize("splice", [True, False])
def test_the_genetic_decision_keeps_its_windows_and_draws(splice):
    ratios = [-math.inf, -40.0, -2.0, -0.3, -1e-9, 0.0, 1e-9, 2.0, 29.9,
              30.0, 49.9, 50.0, 80.0, math.inf, math.nan] * 3
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for r in ratios:
        ok, u = Sampler._gmc_decide(a, r, splice)
        assert ok == bool(_jax_accept(b, r, splice)), r
        assert (u is None) == (not r < 0)
    assert a.random() == b.random()
