"""Recorded MD segments (openmmgridforce_tpu_torch.mm.graphs) and the
streamed engine's per-replica noise, on the CPU in float64.

On the CPU a segment's block function runs as it is, so the buffer and
noise bookkeeping that the card records into CUDA graphs is held here
against the plain loop of steps (``run_segment``), bit for bit, and
against the JAX package under fed noise. The recorded branches of the
entry points are reached by declaring the CPU state recordable
(``_recorded``). The streamed engine draws a segment's noise once per
replica: at friction 5 a run forced through a crossing retry, and a run
split into other region groups, equal the run on one whole-grid region
to 1e-10 nm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from openmmgridforce_tpu.mm import integrators as jint
from openmmgridforce_tpu.mm import system as jsystem
from openmmgridforce_tpu.parallel import replicas as jrep
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.grid import InterpolationMethod
from openmmgridforce_tpu_torch.io import streaming, write_grid_tiled
from openmmgridforce_tpu_torch.mm import (constraints, graphs, integrators,
                                          streamed_md, system)
from openmmgridforce_tpu_torch.ops import gridgen

from test_torch_md import jax_noise

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def constrained():
    lig, x, _, _ = chip_smoke.synthetic_complex(11, n_ligand=19,
                                                n_receptor=10)
    js = jsystem.system_from_amber(lig, dtype=jnp.float64, hydrogen_mass=4.0,
                                   constraints="HBonds")
    ts = system.system_from_amber(lig, dtype=torch.float64,
                                  hydrogen_mass=4.0, constraints="HBonds",
                                  device="cpu")
    jstates = jrep.init_replica_states(jax.random.PRNGKey(21),
                                       jnp.asarray(x), js.masses, 300.0, 3)
    return lig, js, ts, jstates


@pytest.fixture
def recorded(monkeypatch):
    """Send CPU states down the entry points' recorded branches."""
    for mod in (integrators, system, streamed_md):
        monkeypatch.setattr(mod, "_recorded", lambda state: True)


def _port_states(jstates, seed=0):
    return convert.states_from_arrays(np.asarray(jstates.positions),
                                      np.asarray(jstates.velocities),
                                      seed=seed, device="cpu")


def _force(ts):
    return lambda p: system.energy_and_forces(ts, [], p)[1]


def _same(a, b):
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.velocities, b.velocities)


@pytest.mark.parametrize("n_steps", [1, 4, 10])
@pytest.mark.parametrize("scheme", ["classic", "middle"])
def test_segment_blocks_equal_the_plain_loop(constrained, recorded, n_steps,
                                             scheme):
    """Blocks of 4 and a remainder block over static buffers, the noise
    copied in block by block: bit for bit the plain loop's trajectory."""
    _, _, ts, jstates = constrained
    step = integrators.make_langevin_step(_force(ts), ts.masses, 0.002, 5.0,
                                          300.0, scheme=scheme,
                                          constraints=ts.constraints)
    rng = np.random.default_rng(5)
    noise = torch.from_numpy(rng.standard_normal(
        (n_steps,) + tuple(jstates.positions.shape)))
    seg = integrators.langevin_segment(step, _port_states(jstates))
    assert seg.lengths(n_steps) == [n for n in (4, n_steps % 4)
                                    if n and n <= n_steps]
    plain = _port_states(jstates)
    for s in range(n_steps):
        plain = step(plain, noise[s])
    got = integrators.run_segment(step, _port_states(jstates), n_steps,
                                  noise=noise)
    _same(got, plain)


def test_segment_draws_block_noise_from_the_generator(constrained, recorded):
    """With no noise given, each block's rows come from the state's
    generator in one draw: the same seed gives the same run, and the run
    equals the one fed those rows."""
    _, _, ts, jstates = constrained
    step = integrators.make_langevin_step(_force(ts), ts.masses, 0.002, 5.0,
                                          300.0, constraints=ts.constraints)
    a = integrators.run_segment(step, _port_states(jstates, 3), 6)
    b = integrators.run_segment(step, _port_states(jstates, 3), 6)
    _same(a, b)
    gen = torch.Generator().manual_seed(3)
    shape = tuple(jstates.positions.shape)
    rows = torch.cat([torch.randn((4,) + shape, generator=gen,
                                  dtype=torch.float64),
                      torch.randn((2,) + shape, generator=gen,
                                  dtype=torch.float64)])
    fed = integrators.run_segment(step, _port_states(jstates), 6, noise=rows)
    _same(a, fed)


def test_recorded_trajectory_and_respa_match_jax(constrained, recorded):
    """run_trajectory copies frames out of the per-step buffer and
    run_respa_segment carries the slow force through the blocks: both
    equal the JAX package under fed noise."""
    from openmmgridforce_tpu.mm import forcefield as jff
    from openmmgridforce_tpu.ops import pairwise as jpairwise
    from openmmgridforce_tpu_torch.mm import forcefield
    from openmmgridforce_tpu_torch.ops import pairwise

    _, js, ts, jstates = constrained
    shape = jstates.positions.shape[1:]

    def jforce(p):
        return jsystem.energy_and_forces(js, [], p)[1]

    jstep = jint.make_langevin_step(jforce, js.masses, 0.002, 5.0, 300.0,
                                    constraints=js.constraints)
    n_steps, every = 10, 5
    ref_final, ref_traj = jax.jit(jax.vmap(
        lambda s: jint.run_trajectory(jstep, s, n_steps, every)))(jstates)
    noise = torch.from_numpy(jax_noise(list(jstates.key), n_steps, shape))
    tstep = integrators.make_langevin_step(_force(ts), ts.masses, 0.002,
                                           5.0, 300.0,
                                           constraints=ts.constraints)
    final, traj = integrators.run_trajectory(tstep, _port_states(jstates),
                                             n_steps, every, noise=noise)
    np.testing.assert_allclose(traj.numpy(),
                               np.moveaxis(np.asarray(ref_traj), 1, 0),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(final.positions.numpy(),
                               np.asarray(ref_final.positions), rtol=0,
                               atol=1e-10)

    n_outer, n_inner = 5, 4

    def jslow(p):
        return jpairwise.pair_energy_forces(js.pairs, p)[1]

    def jfast(p):
        return jff.bonded_energy_forces(p, js)[1]

    jr = jint.make_respa_langevin_step(jslow, jfast, js.masses, 0.002,
                                       n_inner, 5.0, 300.0,
                                       constraints=js.constraints)
    ref = jax.jit(jax.vmap(lambda s: jint.run_respa_segment(
        jr, jslow, s, n_outer)))(jstates)
    rn = jax_noise(list(jstates.key), n_outer * n_inner, shape)
    rn = torch.from_numpy(rn.reshape((n_outer, n_inner) + rn.shape[1:]))

    def tslow(p):
        return pairwise.pair_energy_forces(ts.pairs, p)[1]

    def tfast(p):
        return forcefield.bonded_energy_forces(p, ts)[1]

    tr = integrators.make_respa_langevin_step(tslow, tfast, ts.masses,
                                              0.002, n_inner, 5.0, 300.0,
                                              constraints=ts.constraints)
    got = integrators.run_respa_segment(tr, tslow, _port_states(jstates),
                                        n_outer, noise=rn)
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(ref.positions), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got.velocities.numpy(),
                               np.asarray(ref.velocities), rtol=0,
                               atol=1e-7)


def test_md_runner_shares_one_recording(constrained, recorded):
    """Runners of one system reuse one cached segment, whose temperature
    buffer takes each call's ladder: the results equal the plain runner's
    bit for bit."""
    _, _, ts, jstates = constrained
    system._SEGMENTS.clear()
    rng = np.random.default_rng(9)
    shape = tuple(jstates.positions.shape)
    for n_steps, temps in ((8, [300.0, 330.0, 360.0]), (6, 310.0)):
        noise = torch.from_numpy(rng.standard_normal((n_steps,) + shape))
        run = system.make_md_runner(n_steps, 0.002, 5.0, device="cpu")
        got = run(_port_states(jstates), ts, [], torch.as_tensor(temps),
                  noise=noise)
        plain = system.make_md_runner(n_steps, 0.002, 5.0, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(system, "_recorded", lambda state: False)
            want = plain(_port_states(jstates), ts, [],
                         torch.as_tensor(temps), noise=noise)
        _same(got, want)
    assert len(system._SEGMENTS) == 1
    seg = next(iter(system._SEGMENTS.values()))
    assert sorted(seg.segment._blocks) == [2, 4]


def test_md_runner_unbatched_matches_jax(constrained):
    """make_md_runner(batched=False) takes one [N, 3] state and one
    temperature, as the JAX runner does."""
    _, js, ts, jstates = constrained
    one = jax.tree.map(lambda a: a[0], jstates)
    n_steps = 6
    ref = jsystem.make_md_runner(n_steps, 0.002, 5.0, batched=False)(
        one, js, [], 320.0)
    noise = jax_noise([one.key], n_steps, one.positions.shape)[:, 0]
    state = convert.states_from_arrays(np.asarray(one.positions),
                                       np.asarray(one.velocities), seed=0,
                                       device="cpu")
    run = system.make_md_runner(n_steps, 0.002, 5.0, device="cpu",
                                batched=False)
    got = run(state, ts, [], 320.0, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(ref.positions), rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        run(_port_states(jstates), ts, [], 320.0)


def test_system_without_nonbonded_matches_jax(constrained):
    """system_from_amber(include_nonbonded=False): no pair table, the
    bonded energy and forces alone, in both packages."""
    lig, _, _, jstates = constrained
    js = jsystem.system_from_amber(lig, dtype=jnp.float64,
                                   include_nonbonded=False)
    ts = system.system_from_amber(lig, dtype=torch.float64,
                                  include_nonbonded=False, device="cpu")
    assert js.pairs is None and ts.pairs is None
    x = np.asarray(jstates.positions)[0]
    e_j, f_j = jsystem.energy_and_forces(js, [], jnp.asarray(x))
    e_t, f_t = system.energy_and_forces(ts, [], torch.from_numpy(x))
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-12)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("kind", ["shake", "rattle"])
def test_each_replica_relaxes_as_if_alone(constrained, kind):
    """The property the card's kernel rests on (a block a replica, each
    stopping at its own sweep): the batched twin's state and per-replica
    sweeps equal each replica relaxed alone, bit for bit, for caps 150, 6
    and 3 (a stopped replica's masked sweeps add exact zeros)."""
    _, _, ts, jstates = constrained
    cs = ts.constraints
    x_ref = torch.from_numpy(np.asarray(jstates.positions))
    rng = np.random.default_rng(4)
    x_new = x_ref + torch.from_numpy(rng.normal(0.0, 0.004, x_ref.shape))
    v = torch.from_numpy(rng.standard_normal(x_ref.shape))
    if kind == "shake":
        def relax(i, max_iter):
            return constraints.shake_plain(cs, x_ref[i], x_new[i],
                                           max_iter=max_iter)
    else:
        def relax(i, max_iter):
            return constraints.rattle_plain(cs, x_ref[i], v[i],
                                            max_iter=max_iter)
    whole = slice(None)
    for max_iter in (150, 6, 3):
        state, sweeps = relax(whole, max_iter)
        alone = [relax(i, max_iter) for i in range(len(x_ref))]
        assert torch.equal(state, torch.stack([a[0] for a in alone]))
        assert torch.equal(sweeps, torch.stack([a[1] for a in alone]))
        assert int(sweeps.max()) <= max_iter


# ----------------------------------------------------------------------
# The streamed engine's per-replica noise
# ----------------------------------------------------------------------

COUNTS = (33, 33, 33)
SPACING = (0.125,) * 3
ORIGIN = (-1.0, -1.0, -1.0)
OFFSETS = np.array([[0.0, 0.0, 0.0], [2.0, 0.1, 0.2], [0.1, 2.1, 0.1],
                    [2.0, 2.0, 2.0], [0.2, 0.1, 2.1]])
NARROW = (18, 18, 18)     # one region per cloud


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    d = tmp_path_factory.mktemp("segment")
    lig, x, _, _ = chip_smoke.synthetic_complex(3, n_ligand=10,
                                                n_receptor=10)
    rng = np.random.default_rng(31)
    rec = rng.uniform(-0.5, 2.7, (15, 3))
    q = rng.uniform(-0.2, 0.2, 15)
    paths, scals = [], []
    for gt in ("charge", "lja"):
        g = gridgen.generate_grid(COUNTS, SPACING, ORIGIN, gt, rec, q,
                                  np.full(15, 0.32), np.full(15, 0.4),
                                  grid_cap=400.0, dtype=torch.float64,
                                  device="cpu")
        paths.append(str(d / f"{gt}.tiled"))
        write_grid_tiled(paths[-1], g, tile_size=8)
        scals.append(gridgen.auto_scaling_factors(
            gt, lig.charges, lig.sigmas, lig.epsilons))
    ts = system.system_from_amber(lig, dtype=torch.float64, device="cpu")
    return dict(x=x - x.min(0), ts=ts, paths=paths, scals=scals)


def _stream_run(world, region, vel, n_steps=40):
    evs = [streaming.StreamedGridEvaluator(
        p, InterpolationMethod.BSPLINE, region_shape=region,
        dtype=torch.float64, device="cpu") for p in world["paths"]]
    md = streamed_md.StreamedBatchMD(evs, world["scals"], world["ts"],
                                     dt=0.0005, friction=5.0,
                                     refresh_steps=20)
    pos = np.stack([world["x"] + off for off in OFFSETS])
    states = convert.states_from_arrays(pos, vel, seed=7, device="cpu")
    out = md.run(states, 300.0, n_steps)
    return out, md


def test_streamed_retry_replays_the_noise(streamed):
    """At friction 5 a replica outruns its narrow region and the segment
    re-runs through the retry ladder: with the chunk's noise drawn once per
    replica the run equals the one on a whole-grid region, which needs no
    retry, to 1e-10."""
    vel = np.zeros((len(OFFSETS),) + streamed["x"].shape)
    vel[2, :, 0] = 40.0          # the whole cloud runs along x
    ref, md_ref = _stream_run(streamed, COUNTS, vel)
    got, md = _stream_run(streamed, NARROW, vel)
    assert md_ref.crossing_retries == 0 and md.crossing_retries > 0
    np.testing.assert_allclose(got.positions.numpy(),
                               ref.positions.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.velocities.numpy(),
                               ref.velocities.numpy(), rtol=0, atol=1e-8)


def test_streamed_noise_does_not_depend_on_the_grouping(streamed):
    """The same replicas split into several region groups (no retry)
    follow the trajectories they follow as one group, to 1e-10."""
    vel = np.zeros((len(OFFSETS),) + streamed["x"].shape)
    ref, md_ref = _stream_run(streamed, COUNTS, vel)
    got, md = _stream_run(streamed, NARROW, vel)
    assert md.crossing_retries == 0
    assert len(np.unique(md.sets[0]._starts, axis=0)) == len(OFFSETS)
    assert len(np.unique(md_ref.sets[0]._starts, axis=0)) == 1
    np.testing.assert_allclose(got.positions.numpy(),
                               ref.positions.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.velocities.numpy(),
                               ref.velocities.numpy(), rtol=0, atol=1e-8)


def test_streamed_step_without_noise_still_runs(streamed):
    """A user step_factory whose step takes no noise is called as
    step(state) and draws its own noise, as before."""
    calls = []

    def factory(force_fn, t, base_args):
        inner = integrators.make_langevin_step(force_fn, base_args.masses,
                                               0.0005, 5.0, t)

        def step(state):
            calls.append(1)
            return inner(state)
        return step

    evs = [streaming.StreamedGridEvaluator(
        p, InterpolationMethod.BSPLINE, region_shape=COUNTS,
        dtype=torch.float64, device="cpu") for p in streamed["paths"]]
    md = streamed_md.StreamedBatchMD(sets=[streamed_md.StreamSet(
        evs, streamed["scals"])], system=streamed["ts"], refresh_steps=10,
        step_factory=factory)
    pos = np.stack([streamed["x"] + off for off in OFFSETS[:2]])
    states = convert.states_from_arrays(pos, np.zeros_like(pos), seed=1,
                                        device="cpu")
    out = md.run(states, 300.0, 20)
    assert len(calls) == 20 and torch.isfinite(out.positions).all()
    assert not graphs.takes_noise(factory(None, 300.0, streamed["ts"]))


def test_fixed_order_row_sums_equal_index_add(constrained):
    """The card's row sums (a gather through a per-atom table, a weighted
    sum) give index_add_'s result, and the table is made once per key."""
    from openmmgridforce_tpu_torch.ops import scatter

    _, _, ts, jstates = constrained
    idx = torch.cat([ts.bond_idx[:, 0], ts.bond_idx[:, 1],
                     ts.angle_idx[:, 1]])
    rng = np.random.default_rng(2)
    src = torch.from_numpy(rng.standard_normal((3, len(idx), 3)))
    x = torch.from_numpy(np.asarray(jstates.positions))
    keys = (ts.bond_idx, ts.angle_idx)
    plan = scatter.fixed_order_plan(idx, x.shape[-2], keys,
                                    dtype=torch.float64)
    got = scatter.add_rows(x.clone(), plan, src)
    want = x.clone().index_add_(-2, idx, src)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-13)
    cpu = scatter.row_sum_plan(idx, x.shape[-2], keys)
    assert cpu.sel is None
    assert torch.equal(scatter.add_rows(x.clone(), cpu, src), want)
    again = scatter.fixed_order_plan(idx[:len(idx)], x.shape[-2], keys,
                                     dtype=torch.float64)
    assert again.sel is plan.sel and again.weight is plan.weight
    table = scatter.row_table(idx, x.shape[-2])
    counts = np.bincount(idx.numpy(), minlength=x.shape[-2])
    assert table.shape == (x.shape[-2], counts.max())
    assert int((table < len(idx)).sum()) == len(idx)


def test_fixed_order_row_sums_with_factors(constrained):
    """The constraint solver's form: C pair updates applied to both atoms
    of every pair, weighted -1/m_i and +1/m_j, equal the index_add_ of the
    explicit rows; padding slots add exactly nothing."""
    from openmmgridforce_tpu_torch.ops import scatter

    _, _, ts, jstates = constrained
    cs = ts.constraints
    idx = torch.cat([cs.idx[:, 0], cs.idx[:, 1]])
    coef = torch.cat([-cs.inv_mass[cs.idx[:, 0]], cs.inv_mass[cs.idx[:, 1]]])
    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.asarray(jstates.positions))
    update = torch.from_numpy(rng.standard_normal(
        (x.shape[0], cs.num_constraints, 3)))
    explicit = torch.cat([update, update], dim=-2) * coef[:, None]
    want = x.clone().index_add_(-2, idx, explicit)
    for plan in (scatter.fixed_order_plan(idx, x.shape[-2], (cs.idx,),
                                          coef=coef,
                                          src_rows=cs.num_constraints),
                 scatter.row_sum_plan(idx, x.shape[-2], (cs.idx,),
                                      coef=coef,
                                      src_rows=cs.num_constraints)):
        got = scatter.add_rows(x.clone(), plan, update)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-13)
    # an atom in no constraint keeps its position bit for bit
    free = np.setdiff1d(np.arange(x.shape[-2]), idx.numpy())
    assert free.size
    assert torch.equal(got[:, free], x[:, free])


def test_streamed_recorded_groups_pad_to_size_buckets(streamed, recorded):
    """Recorded group segments run at the next power of two of the group
    size, the group padded with copies of its first replica: three
    replicas sharing a region are recorded as four, and every replica
    follows the trajectory of the plain run, to 1e-10."""
    offsets = OFFSETS[[0, 0, 0, 3, 3]]
    vel = np.zeros((len(offsets),) + streamed["x"].shape)
    vel[:, :, 1] = np.linspace(-1.0, 1.0, len(offsets))[:, None]

    def run():
        evs = [streaming.StreamedGridEvaluator(
            p, InterpolationMethod.BSPLINE, region_shape=NARROW,
            dtype=torch.float64, device="cpu") for p in streamed["paths"]]
        md = streamed_md.StreamedBatchMD(evs, streamed["scals"],
                                         streamed["ts"], dt=0.0005,
                                         friction=5.0, refresh_steps=20)
        pos = np.stack([streamed["x"] + off for off in offsets])
        states = convert.states_from_arrays(pos, vel, seed=7, device="cpu")
        return md.run(states, 300.0, 40), md

    got, md = run()
    sizes = sorted({key[1][0] for key in md._graphs})
    assert sizes == [2, 4] and md.crossing_retries == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(streamed_md, "_recorded", lambda state: False)
        ref, _ = run()
    np.testing.assert_allclose(got.positions.numpy(),
                               ref.positions.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.velocities.numpy(),
                               ref.velocities.numpy(), rtol=0, atol=1e-8)
    assert streamed_md._group_size(1, 100) == 1
    assert streamed_md._group_size(33, 100) == 64
    assert streamed_md._group_size(70, 100) == 100


def test_streamed_recordings_hold_only_resident_payloads(streamed,
                                                         recorded):
    """Direct-stencil payloads (no pack budget) are region grids of the
    evaluators' region LRUs: a recording whose grids left an LRU is
    dropped after the segment, so recordings hold no region the caches
    no longer count."""
    evs = [streaming.StreamedGridEvaluator(
        p, InterpolationMethod.BSPLINE, region_shape=NARROW,
        dtype=torch.float64, device="cpu") for p in streamed["paths"]]
    for ev in evs:
        ev.device_regions = 2
    sset = streamed_md.StreamSet(evs, streamed["scals"], pack_budget_bytes=0)
    md = streamed_md.StreamedBatchMD(sets=[sset], system=streamed["ts"],
                                     dt=0.0005, friction=5.0,
                                     refresh_steps=20)
    pos = np.stack([streamed["x"] + off for off in OFFSETS])
    states = convert.states_from_arrays(pos, np.zeros_like(pos), seed=3,
                                        device="cpu")
    out = md.run(states, 300.0, 20)
    assert torch.isfinite(out.positions).all()
    assert sset.direct_builds >= len(OFFSETS) and sset.packs_built == 0
    live = sset.resident_payloads()
    assert 0 < len(md._graphs) <= 2
    for grp in md._graphs.values():
        for pay in grp.payloads:
            assert isinstance(pay, tuple)
            assert live.issuperset(streamed_md._payload_ids(pay))


def test_constraints_through_fixed_order_sums(constrained, monkeypatch):
    """SHAKE and RATTLE with the card's fixed-order row sums (run here on
    the CPU) against index_add_'s: the same positions and velocities to
    1e-12 and the same sweeps per replica."""
    from openmmgridforce_tpu_torch.ops import scatter

    _, _, ts, jstates = constrained
    cs = ts.constraints
    x_ref = torch.from_numpy(np.asarray(jstates.positions))
    rng = np.random.default_rng(6)
    x_new = x_ref + torch.from_numpy(rng.normal(0.0, 0.004, x_ref.shape))
    v = torch.from_numpy(rng.standard_normal(x_ref.shape))
    out = {}
    for form in ("index_add", "fixed_order"):
        if form == "fixed_order":
            monkeypatch.setattr(constraints, "row_sum_plan",
                                scatter.fixed_order_plan)
        xs, ns = constraints.apply_shake(cs, x_ref, x_new)
        vs, nr = constraints.apply_rattle(cs, xs, v)
        out[form] = (xs, ns, vs, nr)
    (xa, na, va, ra), (xb, nb, vb, rb) = out["index_add"], out["fixed_order"]
    np.testing.assert_allclose(xb.numpy(), xa.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(vb.numpy(), va.numpy(), rtol=0, atol=1e-12)
    assert torch.equal(na, nb) and torch.equal(ra, rb)


def test_capture_trace_leaves_the_card_while_while_recordings_live(
        tmp_path, monkeypatch):
    """While a recorded block with a WHILE node is alive, capture_trace
    warns and traces the host only; with none it would trace the card."""
    from openmmgridforce_tpu_torch.utils import observe

    class Block:
        graph = object()

    acts = []
    real = torch.profiler.profile

    def profile(activities, **kw):
        acts.append(list(activities))
        return real(activities=[torch.profiler.ProfilerActivity.CPU], **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "profile", profile)
    blk = Block()
    graphs._WHILE_BLOCKS.add(blk)
    try:
        assert graphs.while_recordings() == 1
        with pytest.warns(RuntimeWarning, match="WHILE"):
            with observe.capture_trace(str(tmp_path / "a")):
                torch.ones(3).sum()
    finally:
        graphs._WHILE_BLOCKS.discard(blk)
    assert graphs.while_recordings() == 0
    with observe.capture_trace(str(tmp_path / "b")):
        torch.ones(3).sum()
    cpu, cuda = (torch.profiler.ProfilerActivity.CPU,
                 torch.profiler.ProfilerActivity.CUDA)
    assert acts == [[cpu], [cpu, cuda]]
    assert (tmp_path / "a" / "trace.json").exists()


def test_dropped_recordings_free_at_once(streamed, recorded):
    """A recorded group segment dropped by the engine frees its recording,
    static buffers and payloads at once, not at the next garbage
    collection: nothing it holds refers back to it."""
    import gc
    import weakref

    md = _stream_run(streamed, NARROW, np.zeros(
        (len(OFFSETS),) + streamed["x"].shape), n_steps=8)[1]
    assert md._graphs
    refs = [weakref.ref(obj) for grp in md._graphs.values()
            for obj in (grp, grp.segment, grp.temperature)]
    gc.disable()
    try:
        md._graphs.clear()
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
