"""The port's scale-out on gloo ranks on the host vs the JAX package
(float64): ``make_sharded_md_runner`` on a dp x sp = 2 x 2 mesh against
JAX's on its (4, 2) mesh with JAX's noise replayed, and against the
port's own one-rank run from one seed; the distributed screen on 2 ranks
against ``tests/dcn_worker.py``'s single-process JAX reference, with
``top_k_poses`` and the ensemble runner beside it; the launcher's failure
path; and the sampler's replica mesh (``sampler_worker``, which
``test_torch_sampling.py`` runs).

Each workload starts its ranks once (``distributed.launch``). The ranks
run the worker functions below, so this module imports no JAX at its top:
a spawned rank imports it and must not load JAX.
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.grid import InterpolationMethod, grid_from_numpy
from openmmgridforce_tpu_torch.mm import MDState, system as msys
from openmmgridforce_tpu_torch.mm.integrators import (make_langevin_step,
                                                      run_segment)
from openmmgridforce_tpu_torch.ops import gridgen, packed
from openmmgridforce_tpu_torch.parallel import (Mesh, distributed,
                                                make_ensemble_runner,
                                                make_sharded_md_runner,
                                                replica_rows,
                                                shard_packed_grid,
                                                shard_replica_states)
from openmmgridforce_tpu_torch.sampling import Sampler, SamplerConfig

MD_STEPS, MD_DT, MD_FRICTION = 20, 0.0005, 2.0
SCREEN_STEPS, SCREEN_DT, SCREEN_FRICTION = 25, 0.001, 5.0
TOP_K = 3


# ----------------------------------------------------------------------
# Workers (run on the ranks)
# ----------------------------------------------------------------------

def md_worker(device, shape, arrays, pairs, vals, x0, temps, noise, seed):
    """20 steps of the sharded runner from zero velocities: once on the
    JAX noise's rows, once on noise drawn from a generator seeded
    ``seed``. Returns this rank's rows of both, and the runner's mode."""
    mesh = Mesh(shape, ("dp", "sp"), device)
    system = convert.system_from_arrays(arrays, pairs=pairs, device=device)
    grid = grid_from_numpy(vals, (0.1,) * 3, interp_method=
                           InterpolationMethod.BSPLINE, dtype=torch.float64,
                           device=device)
    table = shard_packed_grid(
        packed.combine_packed_grids([packed.pack_grid(grid)]), mesh)
    scaling = system.charges[None, :]
    R = temps.shape[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    start = MDState(torch.as_tensor(x0).expand(R, *x0.shape).clone(),
                    torch.zeros((R,) + x0.shape, dtype=torch.float64), gen)
    states = shard_replica_states(mesh, start)
    rows = replica_rows(mesh, R)
    run = make_sharded_md_runner(mesh, MD_STEPS, MD_DT, MD_FRICTION)
    t = torch.as_tensor(temps[rows])
    replayed = run(states, system, table, scaling, t,
                   noise=torch.as_tensor(noise[:, rows]))
    drawn = run(states, system, table, scaling, t)
    return {"rows": (rows.start, rows.stop), "mode": run.mode,
            "replayed": (replayed.positions, replayed.velocities),
            "drawn": (drawn.positions, drawn.velocities)}


def screen_worker(device, arrays, pairs, grid_fields, poses, temps, noise):
    """The distributed screen on this rank's replicas, on the given noise
    and on noise drawn from a seeded generator; the global top-k; and the
    ensemble runner on this rank's rows against run_segment on the whole
    ensemble from the same seed."""
    mesh = distributed.global_replica_mesh(device)
    system = convert.system_from_arrays(arrays, pairs=pairs, device=device)
    grid = convert.grid_from_arrays(**grid_fields, device=device)
    binding = msys.GridBinding(grid=grid, scaling=system.charges)
    system, [binding] = distributed.replicate(mesh, (system, [binding]))
    rows = replica_rows(mesh, poses.shape[0])
    local = distributed.distribute_replicas(
        mesh, MDState(poses[rows], np.zeros_like(poses[rows]), None))
    states = MDState(local.positions, local.velocities,
                     torch.Generator(device=device).manual_seed(1))
    run = distributed.make_distributed_screen(mesh, SCREEN_STEPS, SCREEN_DT,
                                              SCREEN_FRICTION)
    out, energies = run(states, system, [binding],
                        torch.as_tensor(temps[rows]),
                        noise=torch.as_tensor(noise[:, rows]))
    best_e, best_x = distributed.top_k_poses(mesh, energies, out.positions,
                                             TOP_K)
    seeded = torch.Generator(device=device).manual_seed(2)
    drawn, drawn_e = run(MDState(local.positions, local.velocities, seeded),
                         system, [binding], torch.as_tensor(temps[rows]))

    def force_fn(x):
        return msys.energy_and_forces(system, [binding], x)[1]

    step = make_langevin_step(force_fn, system.masses, SCREEN_DT,
                              SCREEN_FRICTION, 300.0)
    ens = make_ensemble_runner(step, 3, mesh)(states)
    whole = torch.as_tensor(poses, device=device)
    ref = run_segment(step, MDState(whole, torch.zeros_like(whole),
                                    torch.Generator().manual_seed(1)), 3)
    return {"rows": (rows.start, rows.stop),
            "positions": distributed.local_shard(out.positions),
            "energies": distributed.local_shard(energies),
            "drawn": (drawn.positions, drawn_e),
            "top_e": best_e, "top_x": best_x,
            "ensemble_equal": torch.equal(ens.positions,
                                          ref.positions[rows])}


def failing_worker(device):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    dist.barrier()


def exit_after_posting_worker(device, code):
    """Posts its result, then (rank 1 alone) exits with ``code`` as the
    interpreter shuts down, after the group is torn down."""
    import atexit
    import os
    import torch.distributed as dist

    if dist.get_rank() == 1:
        atexit.register(os._exit, code)
    dist.barrier()
    return dist.get_rank()


def hang_after_posting_worker(device):
    """Posts its result, then (rank 0 alone) never exits."""
    import atexit
    import torch.distributed as dist

    if dist.get_rank() == 0:
        atexit.register(time.sleep, 3600)
    return dist.get_rank()


def _sampler_complex(device):
    """test_torch_sampling.py's complex, built by the port alone: a
    17-atom ligand with HBonds on fused B-spline grids from 150 receptor
    atoms."""
    lig, x, rec, rec_x = chip_smoke.synthetic_complex(
        3, n_ligand=17, n_receptor=150, gap=0.5)
    lo = x.min(0) - 0.5
    counts = tuple(int(c) + 1 for c in np.ceil((x.max(0) + 0.5 - lo) / 0.1))
    types = ("charge", "ljr", "lja")
    grids = [gridgen.generate_grid(
        counts, (0.1,) * 3, lo, gt, rec_x, rec.charges, rec.sigmas,
        rec.epsilons, interp_method=InterpolationMethod.BSPLINE,
        dtype=torch.float64, device=device) for gt in types]
    scaling = np.stack([gridgen.auto_scaling_factors(
        gt, lig.charges, lig.sigmas, lig.epsilons) for gt in types])
    system = msys.system_from_amber(lig, dtype=torch.float64,
                                    hydrogen_mass=4.0, constraints="HBonds",
                                    device=device)
    binding = msys.GridBinding(
        grid=packed.pack_grids_fused(grids, x_chunk=2, device=device),
        scaling=torch.as_tensor(scaling, device=device))
    return lig, x, system, binding


def sampler_worker(device, shape, n_states, n_trials):
    """``n_trials`` trials (exchange and genetic-MC sweeps, 10 MD steps) of
    an ``n_states`` ladder on a mesh of ``shape`` (dp, or dp x sp), or on
    one process without a mesh (shape None). Returns every rung's
    energies and positions and the acceptance counts; on a mesh, also the
    ValueError of a ladder that does not divide over dp."""
    lig, x, system, binding = _sampler_complex(device)
    mesh = (None if shape is None
            else Mesh(shape, ("dp", "sp")[:len(shape)], device))
    bonds = [tuple(b) for b in lig.bond_idx]

    def config(n):
        return SamplerConfig(n_states=n, t_high=600.0, t_min=300.0,
                             dt=0.002, friction=5.0, md_steps_per_trial=10,
                             seed=7)

    sampler = Sampler(system, [binding], x, config(n_states), bonds=bonds,
                      mesh=mesh, device=device)
    sampler.run(n_trials, n_exchange_per_trial=3, n_gmc_per_trial=1)
    n_redrawn = sampler.drain_trapped(threshold_factor=1.0)
    out = {"energies": sampler.potential_energies(),
           "positions": sampler.positions(),
           "velocities": sampler.global_states().velocities,
           "local_rungs": sampler.states.positions.shape[0],
           "n_redrawn": n_redrawn,
           "counts": (sampler.n_exchange_attempted,
                      sampler.n_exchange_accepted,
                      sampler.n_gmc_attempted, sampler.n_gmc_accepted)}
    if mesh is not None:
        try:
            Sampler(system, [binding], x, config(n_states + 1), mesh=mesh,
                    device=device)
        except ValueError as e:
            out["error"] = str(e)
    if len(shape or ()) == 2:
        try:
            Sampler(system, [binding, binding], x, config(n_states),
                    mesh=mesh, device=device)
        except ValueError as e:
            out["sp_error"] = str(e)
    return out


# ----------------------------------------------------------------------
# Tests
# ----------------------------------------------------------------------

def _jax_noise(keys, n_steps, shape):
    """[n_steps, R, *shape] normals as JAX's classic step draws them: one
    split of each replica's key per step."""
    import jax
    import jax.numpy as jnp

    def one(key):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.normal(sub, shape, dtype=jnp.float64)
        return jax.lax.scan(body, key, None, length=n_steps)[1]
    return np.array(jnp.swapaxes(jax.vmap(one)(keys), 0, 1))


def _system_arrays(system):
    arrays = {k: np.asarray(getattr(system, k))
              for k in convert.SYSTEM_FIELDS}
    pairs = None if system.pairs is None else {
        k: np.asarray(getattr(system.pairs, k)) for k in convert.PAIR_FIELDS}
    return arrays, pairs


@pytest.fixture(scope="module")
def md_case():
    """JAX's sharded runner on its (4, 2) mesh (tests/test_sharded.py's
    workload), and the inputs of the port's."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from openmmgridforce_tpu import Grid, InterpolationMethod as JMethod
    from openmmgridforce_tpu.mm.integrators import MDState as JState
    from openmmgridforce_tpu.mm.system import System
    from openmmgridforce_tpu.ops.packed import (combine_packed_grids,
                                                pack_grid)
    from openmmgridforce_tpu.ops.pairwise import build_pair_table
    from openmmgridforce_tpu.parallel.sharded_grid import (
        make_sharded_md_runner as jrunner, shard_packed_grid as jshard)

    mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("dp", "sp"))
    rng = np.random.default_rng(8)
    vals = rng.standard_normal((13, 9, 9))
    grid = Grid.create(vals, (0.1, 0.1, 0.1), (0.0, 0.0, 0.0),
                       interp_method=JMethod.BSPLINE, dtype=np.float64)
    sharded = jshard(combine_packed_grids([pack_grid(grid)]), mesh,
                     axis="sp")
    n_atoms, R = 6, 8
    charges = rng.uniform(-0.3, 0.3, n_atoms)
    system = System(
        masses=jnp.full((n_atoms,), 12.0),
        charges=jnp.asarray(charges),
        sigmas=jnp.full((n_atoms,), 0.25),
        epsilons=jnp.full((n_atoms,), 0.4),
        bond_idx=jnp.asarray([[i, i + 1] for i in range(n_atoms - 1)],
                             jnp.int32),
        bond_k=jnp.full((n_atoms - 1,), 5e4),
        bond_r0=jnp.full((n_atoms - 1,), 0.15),
        angle_idx=jnp.zeros((0, 3), jnp.int32),
        angle_k=jnp.zeros(0), angle_t0=jnp.zeros(0),
        torsion_idx=jnp.zeros((0, 4), jnp.int32),
        torsion_k=jnp.zeros(0), torsion_per=jnp.zeros(0),
        torsion_phase=jnp.zeros(0),
        pairs=build_pair_table(charges, np.full(n_atoms, 0.25),
                               np.full(n_atoms, 0.4),
                               exclusions=[(i, i + 1)
                                           for i in range(n_atoms - 1)]))
    x0 = (0.45 + 0.12 * np.arange(n_atoms)[:, None]
          * np.array([[1.0, 0.2, 0.1]])
          + rng.uniform(-0.01, 0.01, (n_atoms, 3)))
    keys = jax.vmap(jax.random.PRNGKey)(np.arange(R))
    states = JState(jnp.broadcast_to(jnp.asarray(x0), (R, n_atoms, 3)),
                    jnp.zeros((R, n_atoms, 3)), keys)
    temps = np.linspace(280.0, 340.0, R)
    dp_spec = NamedSharding(mesh, P("dp"))
    states = jax.tree.map(lambda a: jax.device_put(a, dp_spec), states)
    with mesh:
        ref = jrunner(mesh, MD_STEPS, dt=MD_DT, friction=MD_FRICTION)(
            states, system, sharded, jnp.asarray(charges)[None, :],
            jnp.asarray(temps))
    noise = _jax_noise(keys, MD_STEPS, (n_atoms, 3))
    arrays, pairs = _system_arrays(system)
    inputs = (arrays, pairs, vals, x0, temps, noise, 11)
    return inputs, (np.asarray(ref.positions), np.asarray(ref.velocities))


@pytest.fixture(scope="module")
def md_ranks(md_case):
    inputs, _ = md_case
    mesh_run = distributed.launch(md_worker, 4, ((2, 2),) + inputs,
                                  device="cpu")
    one_rank = distributed.launch(md_worker, 1, ((1, 1),) + inputs,
                                  device="cpu")
    return mesh_run, one_rank[0]


def _stitch(ranks, key, R=8):
    x = torch.empty((R, 6, 3), dtype=torch.float64)
    v = torch.empty_like(x)
    for rank in ranks:
        lo, hi = rank["rows"]
        x[lo:hi], v[lo:hi] = rank[key]
    return x, v


def test_sharded_md_runner_matches_jax(md_case, md_ranks):
    """dp x sp = 2 x 2 against JAX's (4, 2) mesh under JAX's noise,
    1e-10; the ranks of one sp group agree exactly."""
    mesh_run, _ = md_ranks
    want_x, want_v = md_case[1]
    assert {r["rows"] for r in mesh_run} == {(0, 4), (4, 8)}
    assert {r["mode"] for r in mesh_run} == {"eager"}
    x, v = _stitch(mesh_run, "replayed")
    np.testing.assert_allclose(x.numpy(), want_x, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), want_v, rtol=1e-10, atol=1e-12)
    assert np.abs(want_x - md_case[0][3]).max() > 1e-4
    for a, b in ((0, 1), (2, 3)):
        assert torch.equal(mesh_run[a]["replayed"][0],
                           mesh_run[b]["replayed"][0])


def test_sharded_md_runner_layout_free(md_ranks):
    """The same seed on one rank and on 2 x 2 ranks: bit for bit, on the
    replayed noise and on the generator's own draws."""
    mesh_run, one = md_ranks
    for key in ("replayed", "drawn"):
        x, v = _stitch(mesh_run, key)
        assert torch.equal(x, one[key][0])
        assert torch.equal(v, one[key][1])
    assert not torch.equal(one["drawn"][0], one["replayed"][0])


@pytest.fixture(scope="module")
def screen_case(tmp_path_factory):
    """tests/dcn_worker.py's workload and its single-process reference."""
    import jax
    import jax.numpy as jnp

    import dcn_worker
    from openmmgridforce_tpu.mm.integrators import (make_langevin_step as
                                                    jstep, run_segment as
                                                    jrun)
    from openmmgridforce_tpu.mm.system import energy_and_forces as jef

    system, grids, states, temps = dcn_worker.build_workload(
        8, jnp.float64)

    @jax.jit
    def ref_run(states, system, grids, temps):
        def one(state, t):
            def force_fn(x):
                return jef(system, grids, x)[1]
            step = jstep(force_fn, system.masses, SCREEN_DT,
                         SCREEN_FRICTION, t)
            out = jrun(step, state, SCREEN_STEPS)
            return out, jef(system, grids, out.positions)[0]
        return jax.vmap(one)(states, temps)

    out, energies = ref_run(states, system, grids, temps)
    g = grids[0].grid
    grid_fields = {"vals": np.asarray(g.vals),
                   "spacing": np.asarray(g.spacing),
                   "origin": np.asarray(g.origin),
                   "interp_method": g.interp_method,
                   "inv_power_mode": g.inv_power_mode,
                   "inv_power": g.inv_power, "grid_cap": g.grid_cap,
                   "oob_k": g.oob_k}
    noise = _jax_noise(states.key, SCREEN_STEPS, states.positions.shape[1:])
    arrays, pairs = _system_arrays(system)
    inputs = (arrays, pairs, grid_fields, np.asarray(states.positions),
              np.asarray(temps), noise)
    return inputs, np.asarray(out.positions), np.asarray(energies)


@pytest.fixture(scope="module")
def screen_ranks(screen_case):
    """The screen on 2 ranks, and on one."""
    return (distributed.launch(screen_worker, 2, screen_case[0],
                               device="cpu"),
            distributed.launch(screen_worker, 1, screen_case[0],
                               device="cpu")[0])


def test_distributed_screen_matches_jax(screen_case, screen_ranks):
    """Two ranks of four replicas each against the single-process JAX
    reference of dcn_worker.py, 1e-12."""
    _, want_x, want_e = screen_case
    x = np.empty_like(want_x)
    e = np.empty_like(want_e)
    for rank in screen_ranks[0]:
        lo, hi = rank["rows"]
        assert hi - lo == 4
        x[lo:hi], e[lo:hi] = rank["positions"], rank["energies"]
    np.testing.assert_allclose(x, want_x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(e, want_e, rtol=1e-12, atol=1e-12)
    assert all(rank["ensemble_equal"] for rank in screen_ranks[0])
    assert screen_ranks[1]["ensemble_equal"]


def test_distributed_screen_layout_free(screen_ranks):
    """The screen on noise drawn from one seed: 2 ranks give the one-rank
    screen's poses and energies bit for bit."""
    two, one = screen_ranks
    x, e = one["drawn"]
    for rank in two:
        lo, hi = rank["rows"]
        assert torch.equal(rank["drawn"][0], x[lo:hi])
        assert torch.equal(rank["drawn"][1], e[lo:hi])
    assert not np.array_equal(x.numpy(), one["positions"])


def test_top_k_poses_matches_jax(screen_case, screen_ranks):
    """The global top-k from the ranks' shards equals JAX's top_k_poses
    on the whole ensemble, exactly, on every rank."""
    from openmmgridforce_tpu.parallel.distributed import (top_k_poses as
                                                          jtop)

    _, want_x, want_e = screen_case
    x = np.empty_like(want_x)
    e = np.empty_like(want_e)
    for rank in screen_ranks[0]:
        lo, hi = rank["rows"]
        x[lo:hi], e[lo:hi] = rank["positions"], rank["energies"]
    ref_e, ref_x = jtop(e, x, TOP_K)
    for rank in screen_ranks[0] + [screen_ranks[1]]:
        np.testing.assert_array_equal(rank["top_e"].numpy(),
                                      np.asarray(ref_e))
        np.testing.assert_array_equal(rank["top_x"].numpy(),
                                      np.asarray(ref_x))


def test_launch_fails_with_the_rank_traceback():
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        distributed.launch(failing_worker, 3, device="cpu", timeout=120)


def test_launch_fails_when_a_rank_exits_non_zero_after_posting():
    """A rank whose exit fails after its result is posted fails the
    launch, with its stages in the message; a clean launch returns each
    rank's stages."""
    with pytest.raises(RuntimeError, match=r"rank 1 exited with code 3 "
                       r"after posting its result; stages \{'spawn'"):
        distributed.launch(exit_after_posting_worker, 2, (3,),
                           device="cpu", timeout=120)
    ok = distributed.launch(exit_after_posting_worker, 2, (0,),
                            device="cpu", timeout=120)
    assert list(ok) == [0, 1]
    for st in ok.stages:
        assert list(st) == ["spawn", "initialize", "work", "post",
                            "destroy", "exit", "total", "result_bytes"]
        assert st["total"] == pytest.approx(sum(
            st[k] for k in ("spawn", "initialize", "work", "post",
                            "destroy", "exit")))


def test_launch_fails_when_a_rank_does_not_stop(monkeypatch):
    monkeypatch.setattr(distributed, "STOP_TIMEOUT", 3.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 is still running 3.0 s "
                       "after the last result; stages"):
        distributed.launch(hang_after_posting_worker, 2, device="cpu",
                           timeout=120)
    assert time.monotonic() - t0 < 60
