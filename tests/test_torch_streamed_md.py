"""Port StreamedBatchMD / StreamSet (openmmgridforce_tpu_torch.mm.
streamed_md) vs the JAX package on the same OMGTILE files, on the CPU in
float64.

Friction 0 and temperature 0, so neither side draws noise that the other
would have to replay. Both evaluate float64 regions of the files' float32
values (the JAX evaluator's ``Grid.create`` is handed ``dtype=float64``)
on a grid whose spacing and origin are exact in binary. Each scenario of
``tests/test_streamed_md_batch.py`` is run segment by segment in both
packages: the trajectories agree to 1e-10 nm (and nm/ps), and the region
starts, full-grid flags, calm counts and build counters are equal after
every segment. The ligand is ``chip_smoke.synthetic_complex``'s (the JAX
tests read AMBER fixtures that are absent here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from openmmgridforce_tpu.grid import Grid as JGrid
from openmmgridforce_tpu.grid import InterpolationMethod as JMethod
from openmmgridforce_tpu.io import streaming as jstreaming
from openmmgridforce_tpu.mm import streamed_md as jsmd
from openmmgridforce_tpu.mm import system as jsystem
from openmmgridforce_tpu.mm.integrators import MDState as JState
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.grid import InterpolationMethod
from openmmgridforce_tpu_torch.io import streaming, write_grid_tiled
from openmmgridforce_tpu_torch.mm import streamed_md as smd
from openmmgridforce_tpu_torch.mm import system
from openmmgridforce_tpu_torch.ops import gridgen

from test_torch_io import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

COUNTS = (33, 33, 33)
SPACING = (0.125,) * 3
ORIGIN = (-1.0, -1.0, -1.0)
GRID_TYPES = ("charge", "lja")
OFFSETS = np.array([[0.0, 0.0, 0.0], [1.3, 0.1, 0.2], [0.1, 1.4, 0.1],
                    [1.2, 1.3, 1.2], [0.2, 0.1, 1.4], [5.0, 5.0, 5.0]])


class _JGridF64:
    @staticmethod
    def create(*args, **kw):
        kw["dtype"] = np.float64
        return JGrid.create(*args, **kw)


@pytest.fixture(autouse=True)
def jax_regions_in_f64(monkeypatch):
    monkeypatch.setattr(jstreaming, "Grid", _JGridF64)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ligand in both packages, the grid files and scalings."""
    d = tmp_path_factory.mktemp("smd")
    lig, x, _, _ = chip_smoke.synthetic_complex(3, n_ligand=10,
                                                n_receptor=10)
    x = x - x.min(0)
    rng = np.random.default_rng(31)
    rec = rng.uniform(-0.5, 2.7, (15, 3))
    q = rng.uniform(-0.2, 0.2, 15)
    paths, scals = [], []
    for gt in GRID_TYPES:
        g = gridgen.generate_grid(COUNTS, SPACING, ORIGIN, gt, rec, q,
                                  np.full(15, 0.32), np.full(15, 0.4),
                                  grid_cap=400.0, dtype=torch.float64,
                                  device="cpu")
        paths.append(str(d / f"{gt}.tiled"))
        write_grid_tiled(paths[-1], g, tile_size=8)
        scals.append(gridgen.auto_scaling_factors(
            gt, lig.charges, lig.sigmas, lig.epsilons))
    js = jsystem.system_from_amber(lig, dtype=jnp.float64)
    ts = system.system_from_amber(lig, dtype=torch.float64, device="cpu")
    return dict(x=x, js=js, ts=ts, paths=paths, scals=scals)


def _evaluators(world, region=(20, 20, 20), paths=None):
    paths = paths or world["paths"]
    t = [streaming.StreamedGridEvaluator(
        p, InterpolationMethod.BSPLINE, region_shape=region,
        dtype=torch.float64, device="cpu") for p in paths]
    j = [jstreaming.StreamedGridEvaluator(
        p, JMethod.BSPLINE, region_shape=region) for p in paths]
    return t, j


def _states(pos, vel):
    n = len(pos)
    js = JState(jnp.asarray(pos), jnp.asarray(vel),
                jax.vmap(jax.random.PRNGKey)(jnp.arange(n)))
    return js, convert.states_from_arrays(pos, vel, seed=0, device="cpu")


def _scattered(world, vel=None):
    pos = np.stack([world["x"] + off for off in OFFSETS])
    return pos, np.zeros_like(pos) if vel is None else vel


def _book(s):
    return convert.stream_set_bookkeeping(s)


def _same_books(tset, jset):
    got, ref = _book(tset), _book(jset)
    assert got.keys() == ref.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def _lockstep(tmd, jmd, jstates, tstates, segments, steps):
    """Run both engines one call of ``steps`` at a time, comparing states
    and every set's bookkeeping after each."""
    for _ in range(segments):
        jstates = jmd.run(jstates, 0.0, steps)
        tstates = tmd.run(tstates, 0.0, steps)
        np.testing.assert_allclose(tstates.positions.numpy(),
                                   np.asarray(jstates.positions),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(tstates.velocities.numpy(),
                                   np.asarray(jstates.velocities),
                                   rtol=0, atol=1e-10)
        for tset, jset in zip(tmd.sets, jmd.sets):
            _same_books(tset, jset)
    return jstates, tstates


def _pair(world, tevs, jevs, steps=10, **kw):
    sets_t = kw.pop("sets_t", None)
    sets_j = kw.pop("sets_j", None)
    common = dict(dt=0.0005, friction=0.0, refresh_steps=steps)
    if sets_t is None:
        tmd = smd.StreamedBatchMD(tevs, world["scals"], world["ts"],
                                  **common)
        jmd = jsmd.StreamedBatchMD(jevs, world["scals"], world["js"],
                                   **common)
    else:
        tmd = smd.StreamedBatchMD(sets=sets_t, system=world["ts"],
                                  **common)
        jmd = jsmd.StreamedBatchMD(sets=sets_j, system=world["js"],
                                   **common)
    return tmd, jmd


def test_scattered_replicas_in_their_own_regions(world):
    """Regions smaller than the scattered clouds' union: per-replica
    regions, grouping, and one replica wholly outside the grid."""
    tevs, jevs = _evaluators(world)
    tmd, jmd = _pair(world, tevs, jevs)
    _lockstep(tmd, jmd, *_states(*_scattered(world)), 3, 10)
    assert tevs[0].region_misses == jevs[0].region_misses >= 3
    assert len(np.unique(tmd.sets[0]._starts, axis=0)) >= 3


def test_union_sharing_one_region(world):
    """Jittered copies of one pose share one sticky region: one file read
    per evaluator and one pack."""
    tevs, jevs = _evaluators(world)
    rng = np.random.default_rng(31)
    pos = np.stack([world["x"] + rng.normal(0, 0.01, world["x"].shape)
                    for _ in range(6)])
    tmd, jmd = _pair(world, tevs, jevs)
    _lockstep(tmd, jmd, *_states(pos, np.zeros_like(pos)), 3, 10)
    assert np.unique(tmd.sets[0]._starts, axis=0).shape[0] == 1
    assert tevs[0].region_misses == 1 and tmd.sets[0].packs_built == 1


def test_region_pool_joins_clusters(world):
    """Two clusters whose union outgrows a region share exactly two
    regions, sticky under jitter, in both packages."""
    tevs, jevs = _evaluators(world)
    tset = smd.StreamSet(tevs, world["scals"])
    jset = jsmd.StreamSet(jevs, world["scals"])
    c0 = np.array([0.3, 0.3, 0.3])
    centers = np.array([c0 + 0.01 * i for i in range(3)]
                       + [c0 + 2.2 + 0.01 * i for i in range(3)])
    ones = np.ones(6, dtype=bool)
    for lo, hi in ((-0.05, 0.05), (-0.06, 0.04)):
        b = (centers + lo, centers + hi, ones)
        np.testing.assert_array_equal(tset.assign(b), jset.assign(b))
        _same_books(tset, jset)
    assert np.unique(tset._starts, axis=0).shape[0] == 2


def test_crossing_retry_recenters(world):
    """A replica whose atom outruns its region mid-segment: the retry
    ladder (quarter-length chunks, the violator's region re-centred) and,
    past it, escalation, step for step as in JAX; then the one-shot
    re-centre request on a fabricated bbox."""
    tevs, jevs = _evaluators(world)
    pos, vel = _scattered(world)
    vel[2, 0] = [6.0, 0.0, 0.0]
    tmd, jmd = _pair(world, tevs, jevs, steps=20)
    _lockstep(tmd, jmd, *_states(pos, vel), 1, 20)
    assert tmd.crossing_retries > 0

    tset, jset = tmd.sets[0], jmd.sets[0]
    lo, hi = (b.numpy() for b in smd._cloud_bounds(
        torch.as_tensor(pos), *(torch.as_tensor(b)
                                for b in tevs[0].full_box)))
    any_in = np.isfinite(lo).all(axis=1)
    lo[0, 0] += 0.3
    hi[0, 0] += 0.3
    for s in (tset, jset):
        s._recenter = np.zeros(len(any_in), dtype=bool)
        s._recenter[0] = True
    np.testing.assert_array_equal(tset.assign((lo, hi, any_in)),
                                  jset.assign((lo, hi, any_in)))
    assert tset._recenter is None and jset._recenter is None


def test_escalation_and_demotion(world):
    """A runaway replica escalates to the full grid in both packages with
    the same trajectory; then the demotion clock: a replica stays on the
    full grid for 3 calm rounds and is demoted on the 4th."""
    tevs, jevs = _evaluators(world, region=(26, 26, 26))
    pos, vel = _scattered(world)
    vel[1] = 40.0
    tmd, jmd = _pair(world, tevs, jevs, steps=20)
    _lockstep(tmd, jmd, *_states(pos, vel), 2, 20)
    assert tmd.sets[0].full_escalations > 0

    tevs, jevs = _evaluators(world, region=(30, 30, 30))
    tset = smd.StreamSet(tevs, world["scals"])
    jset = jsmd.StreamSet(jevs, world["scals"])
    c = np.asarray([[0.4, 0.4, 0.4], [1.2, 1.2, 1.2]])
    bounds = (c - 0.2, c + 0.2, np.ones(2, dtype=bool))
    for _ in range(6):
        np.testing.assert_array_equal(tset.assign(bounds),
                                      jset.assign(bounds))
    tset.escalate([1], 2)
    jset.escalate([1], 2)
    for n in range(5):
        np.testing.assert_array_equal(tset.assign(bounds),
                                      jset.assign(bounds))
        _same_books(tset, jset)
        assert bool(tset._full[1]) == (n < 3)


def test_self_reversing_excursion_is_detected(world):
    """With escalation impossible (budget 0), a cloud that outruns its
    region through the retry ladder raises, with the same message in both
    packages: the check sees the running bbox of every step."""
    tevs, jevs = _evaluators(world)
    pos, vel = _scattered(world)
    vel[2, 0] = [6.0, 0.0, 0.0]
    tmd, jmd = _pair(
        world, tevs, jevs, steps=20,
        sets_t=[smd.StreamSet(tevs, world["scals"],
                              full_region_budget_bytes=0)],
        sets_j=[jsmd.StreamSet(jevs, world["scals"],
                               full_region_budget_bytes=0)])
    js, ts = _states(pos, vel)
    with pytest.raises(RuntimeError, match="crossed their streamed") as te:
        tmd.run(ts, 0.0, 40)
    with pytest.raises(RuntimeError, match="crossed their streamed") as je:
        jmd.run(js, 0.0, 40)
    assert str(te.value) == str(je.value)


def test_subset_atoms(world):
    """A set acting on an atom subset (gathered, forces scattered back
    with index_add_)."""
    tevs, jevs = _evaluators(world)
    idx = np.arange(6)
    sc = [np.asarray(world["scals"][0])[idx]]
    tmd, jmd = _pair(
        world, tevs, jevs,
        sets_t=[smd.StreamSet(tevs[:1], sc, atom_indices=idx)],
        sets_j=[jsmd.StreamSet(jevs[:1], sc, atom_indices=idx)])
    pos, vel = _scattered(world)
    _lockstep(tmd, jmd, *_states(pos[:3], vel[:3]), 2, 10)


def test_pack_budget_direct_fallback(world):
    """Room for one region pack: the largest group packs, every other
    group runs the direct stencil on raw regions."""
    tevs, jevs = _evaluators(world)
    cells = 19 ** 3
    tset = smd.StreamSet(tevs, world["scals"],
                         pack_budget_bytes=int(cells * 128 * 8 * 1.5))
    jset = jsmd.StreamSet(jevs, world["scals"],
                          pack_budget_bytes=int(cells * 128 * 4 * 1.5))
    tmd, jmd = _pair(world, tevs, jevs, sets_t=[tset], sets_j=[jset])
    _lockstep(tmd, jmd, *_states(*_scattered(world)), 2, 10)
    assert len(tset._packed) == 1 and tset.direct_builds > 0


def test_full_payload_replica_exempt_from_check(world, monkeypatch):
    """A replica that the check always flags escalates once and is then
    exempt, in both packages, and the run ends."""
    tevs, jevs = _evaluators(world)

    def flag_zero(real):
        def check(self, run_bounds, interior, idx):
            bad = set(np.asarray(real(self, run_bounds, interior,
                                      idx)).tolist())
            if 0 in np.asarray(idx):
                bad.add(0)
            return np.asarray(sorted(bad), dtype=int)
        return check

    monkeypatch.setattr(smd.StreamSet, "check",
                        flag_zero(smd.StreamSet.check))
    monkeypatch.setattr(jsmd.StreamSet, "check",
                        flag_zero(jsmd.StreamSet.check))
    tmd, jmd = _pair(world, tevs, jevs)
    _lockstep(tmd, jmd, *_states(*_scattered(world)), 2, 10)
    assert bool(tmd.sets[0]._full[0]) and tmd.sets[0].full_escalations == 1
