"""The port's BPMF sampler path vs the JAX package (float64, CPU): BAT
converters, the exchange sweep on JAX's draws, genetic MC from one seed,
an HBonds-constrained ladder segment on slab-packed fused grids with JAX's
velocities and noise replayed, the velocity re-draw, checkpoints, the
replica mesh on gloo ranks against one process, and the example on files
written here (on one process and on 2 dp ranks)."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from openmmgridforce_tpu.grid import InterpolationMethod as JMethod
from openmmgridforce_tpu.mm import system as jsystem
from openmmgridforce_tpu.ops import gridgen as jgridgen
from openmmgridforce_tpu.ops import packed as jpacked
from openmmgridforce_tpu.sampling import Sampler as JSampler
from openmmgridforce_tpu.sampling import SamplerConfig as JConfig
from openmmgridforce_tpu.sampling import bat as jbat
from openmmgridforce_tpu_torch.grid import InterpolationMethod
from openmmgridforce_tpu_torch.mm import system
from openmmgridforce_tpu_torch.ops import gridgen, packed
from openmmgridforce_tpu_torch.parallel import (redraw_hot_velocities,
                                                replica_temperatures)
from openmmgridforce_tpu_torch.sampling import (Sampler, SamplerConfig, bat,
                                                exchange_sweep)
from openmmgridforce_tpu_torch.units import BOLTZ
from openmmgridforce_tpu_torch.parallel import distributed
from openmmgridforce_tpu_torch.utils import load_sampler, save_sampler
from test_torch_scaleout import sampler_worker

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GRID_TYPES = ("charge", "ljr", "lja")
N_STATES = 4
SPACING = 0.1
MARGIN = 0.5


@pytest.fixture(scope="module")
def complex_():
    """A 17-atom ligand on B-spline grids (0.1 nm) from 150 receptor
    atoms: JAX's packs fused by its pack_grids_fused, the port's by its
    own, 2-cell slabs; both systems with HBonds and hydrogen mass 4."""
    lig, x, rec, rec_x = chip_smoke.synthetic_complex(
        3, n_ligand=17, n_receptor=150, gap=0.5)
    lo = x.min(0) - MARGIN
    counts = tuple(int(c) + 1 for c in
                   np.ceil((x.max(0) + MARGIN - lo) / SPACING))
    jgrids, tgrids, scal = [], [], []
    for gt in GRID_TYPES:
        jgrids.append(jgridgen.generate_grid(
            counts, (SPACING,) * 3, lo, gt, rec_x, rec.charges, rec.sigmas,
            rec.epsilons, interp_method=JMethod.BSPLINE, backend="jnp",
            dtype=jnp.float64))
        tgrids.append(gridgen.generate_grid(
            counts, (SPACING,) * 3, lo, gt, rec_x, rec.charges, rec.sigmas,
            rec.epsilons, interp_method=InterpolationMethod.BSPLINE,
            dtype=torch.float64, device="cpu"))
        scal.append(gridgen.auto_scaling_factors(gt, lig.charges,
                                                 lig.sigmas, lig.epsilons))
    scal = np.stack(scal)
    jmulti = jpacked.pack_grids_fused(jgrids, x_chunk=2)
    tmulti = packed.pack_grids_fused(tgrids, x_chunk=2, device="cpu")
    c = np.asarray(jmulti.coeffs)[:, :tmulti.coeffs.shape[1]]
    np.testing.assert_allclose(tmulti.coeffs.numpy(), c, rtol=1e-9,
                               atol=1e-12 * np.abs(c).max())
    js = jsystem.system_from_amber(lig, dtype=jnp.float64, hydrogen_mass=4.0,
                                   constraints="HBonds")
    ts = system.system_from_amber(lig, dtype=torch.float64,
                                  hydrogen_mass=4.0, constraints="HBonds",
                                  device="cpu")
    jb = jsystem.GridBinding(grid=jmulti, scaling=jnp.asarray(scal))
    tb = system.GridBinding(grid=tmulti, scaling=torch.from_numpy(scal))
    bonds = [tuple(b) for b in lig.bond_idx]
    return lig, x, js, jb, ts, tb, bonds


def _config(sampler_config, **kw):
    return sampler_config(**{**dict(n_states=N_STATES, t_high=600.0,
                                    t_min=300.0, dt=0.002, friction=5.0,
                                    md_steps_per_trial=20, seed=7), **kw})


def _samplers(complex_, **kw):
    lig, x, js, jb, ts, tb, bonds = complex_
    jsam = JSampler(js, [jb], jnp.asarray(x), _config(JConfig, **kw),
                    bonds=bonds)
    tsam = Sampler(ts, [tb], x, _config(SamplerConfig, **kw), bonds=bonds,
                   device="cpu")
    return jsam, tsam


def _ladder_conformers(x, bonds, masses, n, seed):
    """``n`` conformations of the ligand with torsions turned at random
    (BAT round trips keep bonds and angles)."""
    z, primary = bat.build_zmatrix(masses, bonds)
    b0 = bat.xyz_to_bat(x, z, primary)
    nt = len(z)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = b0.copy()
        b[9 + 2 * nt:] += rng.uniform(-0.8, 0.8, nt)
        out.append(bat.bat_to_xyz(b, z, primary))
    return np.stack(out)


def _jax_noise(keys, n_steps, shape):
    """[n_steps, R, *shape] normals as JAX's classic step draws them: one
    split of each replica's key per step."""
    def one(key):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.normal(sub, shape, dtype=jnp.float64)
        return jax.lax.scan(body, key, None, length=n_steps)[1]
    return np.array(jnp.swapaxes(jax.vmap(one)(keys), 0, 1))


def test_bat_converters_match_jax_and_numpy(complex_):
    lig, x, _, _, ts, _, bonds = complex_
    masses = ts.masses.numpy()
    z, primary = bat.build_zmatrix(masses, bonds)
    jz, jprimary = jbat.build_zmatrix(masses, bonds)
    np.testing.assert_array_equal(z, jz)
    assert list(primary) == list(jprimary)
    confs = _ladder_conformers(x, bonds, masses, 5, 1)
    x2b, b2x = bat.make_torch_converters(z, primary)
    jx2b, jb2x = jbat.make_jax_converters(z, primary)
    got = x2b(torch.from_numpy(confs)).numpy()
    ref = np.asarray(jax.vmap(jx2b)(jnp.asarray(confs)))
    n = len(z)
    for r, conf in enumerate(confs):
        want = bat.xyz_to_bat(conf, z, primary)
        for other in (ref[r], want):
            np.testing.assert_allclose(got[r, :9 + 2 * n],
                                       other[:9 + 2 * n], rtol=0,
                                       atol=1e-10)
            d = ((got[r, 9 + 2 * n:] - other[9 + 2 * n:] + np.pi)
                 % (2 * np.pi)) - np.pi
            np.testing.assert_allclose(d, 0.0, atol=1e-10)
    back = b2x(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, np.asarray(jax.vmap(jb2x)(
        jnp.asarray(got))), rtol=0, atol=1e-10)
    for r in range(len(confs)):
        np.testing.assert_allclose(back[r], bat.bat_to_xyz(got[r], z,
                                                           primary),
                                   rtol=0, atol=1e-10)
    np.testing.assert_allclose(back, confs, rtol=0, atol=1e-8)
    # one conformation without a batch dimension
    np.testing.assert_allclose(x2b(torch.from_numpy(confs[0])).numpy(),
                               got[0], rtol=0, atol=1e-14)


def test_exchange_sweep_matches_jax(complex_):
    """JAX's on-device sweep and the port's function fed JAX's draws give
    the same permutation and acceptance count."""
    jsam, _ = _samplers(complex_, n_states=7)
    R, n = 7, 40
    energies = np.random.default_rng(5).normal(0.0, 8.0, R)
    # replica r at x = r: the permuted positions name the permutation
    pos = jnp.asarray(np.arange(R, dtype=float)[:, None, None]
                      * np.ones((R, 1, 3)))
    key = jax.random.PRNGKey(17)
    new_pos, n_acc = jsam._exchange_sweep(pos, jnp.asarray(energies), key,
                                          n)
    draws = []
    for _ in range(n):
        key, k1, k2, k3 = jax.random.split(key, 4)
        draws.append((int(jax.random.randint(k1, (), 0, R)),
                      int(jax.random.randint(k2, (), 0, R)),
                      float(jax.random.uniform(k3))))
    i, j, u = (torch.tensor(c) for c in zip(*draws))
    assert (i == j).any()      # the neighbour rule is exercised
    perm, got = exchange_sweep(torch.from_numpy(energies),
                               torch.from_numpy(jsam.betas), i, j,
                               u.to(torch.float64))
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(new_pos)[:, 0, 0].astype(int))
    assert int(got) == int(n_acc)
    assert 0 < int(got) < n


def test_identical_replicas_always_exchange(complex_):
    _, tsam = _samplers(complex_)
    assert tsam.replica_exchange_sweep(10) == 10
    assert tsam.replica_exchange() == 1
    assert (tsam.n_exchange_attempted, tsam.n_exchange_accepted) == (11, 11)


def test_genetic_sweep_matches_jax(complex_):
    """One seed: the same moves, decisions and positions, through a stale
    re-batch."""
    lig, x, _, _, ts, _, bonds = complex_
    jsam, tsam = _samplers(complex_, n_states=6, t_high=2000.0, seed=3)
    pos = _ladder_conformers(x, bonds, ts.masses.numpy(), 6, 2)
    jsam.states = jsam.states._replace(positions=jnp.asarray(pos))
    tsam.states = tsam.states._replace(positions=torch.from_numpy(pos))
    proposals = []
    propose = tsam._gmc_propose
    tsam._gmc_propose = lambda *a: proposals.append(1) or propose(*a)
    np.testing.assert_allclose(tsam.potential_energies(),
                               jsam.potential_energies(), rtol=1e-10)
    for _ in range(2):
        got = tsam.genetic_sweep(4)
        ref = jsam.genetic_sweep(4)
        assert got == ref
    assert tsam.n_gmc_attempted == jsam.n_gmc_attempted == 16
    assert tsam.n_gmc_accepted == jsam.n_gmc_accepted > 0
    assert len(proposals) > 2, "no stale re-batch happened"
    assert tsam._rng.bit_generator.state == jsam._rng.bit_generator.state
    np.testing.assert_allclose(tsam.states.positions.numpy(),
                               np.asarray(jsam.states.positions), rtol=0,
                               atol=1e-10)
    # the host-side single moves consume the rng as JAX's do
    for splice in (True, False):
        e_t, e_j = tsam.potential_energies(), jsam.potential_energies()
        a = tsam._genetic_trial(splice, e_t)
        b = jsam._genetic_trial(splice, e_j)
        assert a == b
        np.testing.assert_allclose(e_t, e_j, rtol=1e-10)
    np.testing.assert_allclose(tsam.states.positions.numpy(),
                               np.asarray(jsam.states.positions), rtol=0,
                               atol=1e-10)


def test_sampler_segment_matches_jax(complex_):
    """One MD trial of the ladder (HBonds, dt 2 fs, slab-packed fused
    B-spline grids) with JAX's fresh velocities and noise replayed."""
    _, x, js, _, ts, _, _ = complex_
    jsam, tsam = _samplers(complex_)
    n_steps = 20
    keys = jsam.states.key
    subs = jax.vmap(jax.random.split)(keys)      # [R, 2, key]
    z = np.stack([np.asarray(jax.random.normal(s, x.shape,
                                               dtype=jnp.float64))
                  for s in subs[:, 1]])
    v = np.sqrt(BOLTZ * jsam.temperatures[:, None]
                / np.asarray(js.masses))[..., None] * z
    noise = _jax_noise(subs[:, 0], n_steps, x.shape)
    jsam.run_md(n_steps)
    tsam.run_md(n_steps, velocities=torch.from_numpy(v),
                noise=torch.from_numpy(noise))
    ref = np.asarray(jsam.states.positions)
    assert np.abs(ref - x).max() > 1e-3
    np.testing.assert_allclose(tsam.states.positions.numpy(), ref, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(tsam.potential_energies(),
                               jsam.potential_energies(), rtol=1e-8)


def test_redraw_hot_velocities_keeps_cold_replicas():
    rng = np.random.default_rng(0)
    R, N = 400, 9
    masses = torch.from_numpy(rng.uniform(1.0, 16.0, N))
    v = torch.from_numpy(rng.standard_normal((R, N, 3)))
    v[1::2] *= 30.0                               # every odd replica hot
    x = torch.from_numpy(rng.standard_normal((R, N, 3)))
    gen = torch.Generator().manual_seed(4)
    from openmmgridforce_tpu_torch.mm.integrators import MDState
    states = MDState(x, v.clone(), gen)
    temps = torch.linspace(300.0, 600.0, R, dtype=torch.float64)
    t_before = replica_temperatures(states, masses)
    out, n = redraw_hot_velocities(states, masses, temps, 5.0 * temps)
    hot = t_before > 5.0 * temps
    assert n == int(hot.sum()) >= R // 2 - 5
    assert torch.equal(out.velocities[~hot], v[~hot])
    assert out.positions is x and out.generator is gen
    # hot replicas at their own target: m v^2 / kT is chi-square(1)
    zz = masses[:, None] * out.velocities[hot] ** 2 \
        / (BOLTZ * temps[hot][:, None, None])
    assert abs(float(zz.mean()) - 1.0) < 5.0 * np.sqrt(2.0 / zz.numel())


def test_drain_trapped(complex_):
    _, tsam = _samplers(complex_)
    assert tsam.drain_trapped() == 0             # starts at zero velocity
    v = tsam.states.velocities.clone()
    v[2] = 10.0
    tsam.states = tsam.states._replace(velocities=v)
    assert tsam.drain_trapped() == 1
    t = replica_temperatures(tsam.states, tsam.system.masses)
    assert float(t[2]) < 5.0 * tsam.temperatures[2]
    cold = [0, 1, 3]
    assert torch.equal(tsam.states.velocities[cold], v[cold])


def test_checkpoint_round_trip(complex_, tmp_path):
    """States, generator, host rng and counters come back: the trial after
    a restore repeats the trial after the save."""
    _, tsam = _samplers(complex_)
    tsam.run(1, n_exchange_per_trial=2, n_gmc_per_trial=1, md_steps=5)
    save_sampler(tmp_path / "ck", tsam)
    saved = (tsam.n_exchange_attempted, tsam.n_exchange_accepted,
             tsam.n_gmc_attempted, tsam.n_gmc_accepted)

    def trial():
        tsam.run(1, n_exchange_per_trial=2, n_gmc_per_trial=1, md_steps=5)
        return (tsam.states.positions.clone(),
                tsam.states.velocities.clone(), tsam._rng.random())

    first = trial()
    load_sampler(tmp_path / "ck", tsam)
    assert (tsam.n_exchange_attempted, tsam.n_exchange_accepted,
            tsam.n_gmc_attempted, tsam.n_gmc_accepted) == saved
    assert tsam.states.generator is tsam.generator
    again = trial()
    assert torch.equal(first[0], again[0])
    assert torch.equal(first[1], again[1])
    assert first[2] == again[2]


MESH_STATES = 6
MESH_TRIALS = 2
MESHES = {"dp3": (3,), "dp3_sp2": (3, 2)}


@pytest.fixture(scope="module")
def mesh_samplers():
    """A 6-state ladder, 2 trials: on one process, and on gloo ranks of
    a dp = 3 and a dp x sp = 3 x 2 mesh (``test_torch_scaleout.
    sampler_worker``; the ranks import no JAX)."""
    one = sampler_worker("cpu", None, MESH_STATES, MESH_TRIALS)
    ranks = {name: distributed.launch(
        sampler_worker, int(np.prod(shape)),
        (shape, MESH_STATES, MESH_TRIALS), device="cpu")
        for name, shape in MESHES.items()}
    return one, ranks


def test_sampler_refuses_a_mesh(mesh_samplers):
    """A ladder that does not divide over the mesh's dp axis is refused
    with the JAX package's message; a dividing one splits its rungs. An
    sp axis of 2 ranks refuses two grid bindings: it splits one table."""
    for name, ranks in mesh_samplers[1].items():
        for rank in ranks:
            assert rank["error"] == (f"n_states={MESH_STATES + 1} must be "
                                     f"divisible by the 'dp' axis size 3")
            assert rank["local_rungs"] == MESH_STATES // 3
            if name == "dp3_sp2":
                assert "got 2 grid bindings" in rank["sp_error"]
            else:
                assert "sp_error" not in rank


@pytest.mark.parametrize("name", list(MESHES))
def test_sampler_mesh_matches_one_process(mesh_samplers, name):
    """Every rank ends with the one-process ladder: energies, positions,
    velocities and acceptance counts, bit for bit (every draw is of the
    whole ladder; the constraint sweeps are per replica)."""
    one, ranks = mesh_samplers[0], mesh_samplers[1][name]
    assert one["counts"][0] == 3 * MESH_TRIALS and one["counts"][2] == \
        2 * MESH_TRIALS
    assert one["counts"][1] > 0 and one["n_redrawn"] > 0
    for rank in ranks:
        assert rank["counts"] == one["counts"]
        assert rank["n_redrawn"] == one["n_redrawn"]
        np.testing.assert_array_equal(rank["energies"], one["energies"])
        for key in ("positions", "velocities"):
            assert torch.equal(rank[key], one[key])


def test_sampler_mesh_matches_one_process_on_avx2(monkeypatch):
    """The dp = 3 ladder against one process, each in processes of their
    own with MKL held to its AVX2 code (a CPU without AVX-512) and the
    ranks on a third of the cores, bit for bit: neither the pack (its
    products sum by the thread count there) nor the torsions' atan2
    (ATen's vectorised loop and scalar tail round apart) depend on how
    many rungs a process holds or on its threads."""
    monkeypatch.setenv("MKL_ENABLE_INSTRUCTIONS", "AVX2")
    (one,) = distributed.launch(sampler_worker, 1,
                                (None, MESH_STATES, MESH_TRIALS),
                                device="cpu")
    ranks = distributed.launch(sampler_worker, 3,
                               ((3,), MESH_STATES, MESH_TRIALS),
                               device="cpu")
    for rank in ranks:
        assert rank["counts"] == one["counts"]
        assert rank["n_redrawn"] == one["n_redrawn"]
        np.testing.assert_array_equal(rank["energies"], one["energies"])
        for key in ("positions", "velocities"):
            assert torch.equal(rank[key], one[key])


def _load_example():
    spec = importlib.util.spec_from_file_location(
        "bpmf_sampler_torch", ROOT / "examples" / "bpmf_sampler_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_example_runs_on_cpu(tmp_path, capsys, monkeypatch):
    """examples/bpmf_sampler_torch.py --device cpu --generate-grids on
    AMBER files written here: 2 trials of a 3-state ladder, on one process
    and on 2 dp ranks (4 states: the ladder divides over dp)."""
    from test_torch_mm import write_inpcrd, write_prmtop

    lig, x, rec, rec_x = chip_smoke.synthetic_complex(
        8, n_ligand=15, n_receptor=120, gap=0.5)
    write_prmtop(tmp_path / "lig.prmtop", lig)
    write_inpcrd(tmp_path / "lig.inpcrd", x)
    write_prmtop(tmp_path / "rec.prmtop", rec)
    write_inpcrd(tmp_path / "rec.inpcrd", rec_x)
    cfg = {"run_job": "CD", "nstate": 3, "ntrial_repX": 2, "ntrial_gMC": 1,
           "nstep_MD": 5, "nstep_equil": 10,
           "CD": {"T_HIGH": 600.0, "T_SIMMIN": 300.0, "H_mass": 4.0,
                  "delta_t": 2.0},
           "dir": {"ligand_prmtop": str(tmp_path / "lig.prmtop"),
                   "ligand_inpcrd": str(tmp_path / "lig.inpcrd"),
                   "receptor_prmtop": str(tmp_path / "rec.prmtop"),
                   "receptor_inpcrd": str(tmp_path / "rec.inpcrd")}}
    (tmp_path / "input.json").write_text(json.dumps(cfg))
    example = _load_example()
    argv = ["-i", str(tmp_path / "input.json"), "--device", "cpu",
            "--n-trials", "2", "--work-dir", str(tmp_path / "out"),
            "--friction", "5", "--drain-rounds", "2", "--grid-spacing",
            "0.1"]
    with pytest.raises(SystemExit, match="'grids'"):
        example.main(argv)
    sampler = example.main(argv + ["--generate-grids"])
    out = capsys.readouterr().out
    assert "2 trials in" in out and "exchange acceptance" in out
    assert sampler.n_exchange_attempted == 4
    assert sampler.n_gmc_attempted == 4
    assert sampler.system.constraints.num_constraints > 0
    table = sampler.grids[0].grid
    assert table.n_grids == 3 and table.coeffs.shape[1] == 192
    assert torch.isfinite(sampler.states.positions).all()
    energies = np.loadtxt(tmp_path / "out" / "energies.dat")
    assert energies.shape == (2, 3) and np.isfinite(energies).all()
    assert (tmp_path / "out" / "traj.xyz").read_text().count("state 0") == 2
    # --dp 2 on a 4-state ladder (it divides over dp): the example starts
    # 2 gloo ranks of its own, so it must be importable by name in them;
    # rank 0 writes what one process writes
    monkeypatch.setitem(sys.modules, "bpmf_sampler_torch", example)
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    (tmp_path / "input.json").write_text(json.dumps({**cfg, "nstate": 4}))
    one = example.main(argv + ["--generate-grids", "--work-dir",
                               str(tmp_path / "one")])
    summary = example.main(argv + ["--generate-grids", "--work-dir",
                                   str(tmp_path / "mesh"), "--dp", "2"])
    assert summary["n_exchange_attempted"] == one.n_exchange_attempted == 4
    assert summary["n_gmc_attempted"] == one.n_gmc_attempted == 4
    # float32 on the host: a rank's batch of 2 rungs rounds apart from the
    # one process's batch of 4 (test_sampler_mesh_matches_one_process
    # holds the float64 ladder bit for bit)
    np.testing.assert_allclose(summary["energies"],
                               one.potential_energies(), rtol=1e-4)
    mesh_energies = np.loadtxt(tmp_path / "mesh" / "energies.dat")
    assert mesh_energies.shape == (2, 4)
    np.testing.assert_allclose(mesh_energies,
                               np.loadtxt(tmp_path / "one" / "energies.dat"),
                               rtol=1e-4)
    assert (tmp_path / "mesh" / "traj.xyz").read_text().count(
        "state 3") == 2
    # --sp splits the generated fused table; the grid files are a pack each
    with pytest.raises(SystemExit, match="--sp splits the fused table"):
        example.main(argv + ["--dp", "1", "--sp", "2"])
