"""Port SHAKE/RATTLE and the constrained System vs the JAX package
(float64, CPU): single conformations and replica batches, replica by
replica down to the sweep at which each stops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from openmmgridforce_tpu.mm import constraints as jcons
from openmmgridforce_tpu.mm import system as jsystem
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.mm import constraints, system

torch.set_num_threads(1)

R = 5


@pytest.fixture(scope="module")
def ligand():
    lig, x, _, _ = chip_smoke.synthetic_complex(5, n_ligand=23,
                                                n_receptor=10)
    js = jsystem.system_from_amber(lig, dtype=jnp.float64, hydrogen_mass=4.0,
                                   constraints="HBonds")
    ts = system.system_from_amber(lig, dtype=torch.float64,
                                  hydrogen_mass=4.0, constraints="HBonds",
                                  device="cpu")
    return lig, x, js, ts


def _pair(ligand, seed, scale, lead=(R,)):
    """Reference positions and a perturbation of them, [*lead, N, 3]."""
    _, x, _, _ = ligand
    rng = np.random.default_rng(seed)
    x_ref = x + 0.003 * rng.standard_normal(lead + x.shape)
    return x_ref, x_ref + scale * rng.standard_normal(lead + x.shape)


def jax_sweeps(fn, max_iter, full):
    """The sweep at which the JAX loop stopped, per replica: the least k
    for which ``fn(max_iter=k)`` gives each replica's ``full`` result
    bitwise (every sweep before the last one changes the result)."""
    full = np.asarray(full)
    lead = full.shape[:-2]
    found = np.zeros(lead, dtype=np.int64)
    for k in range(1, max_iter + 1):
        same = (np.asarray(fn(k)) == full).all((-2, -1))
        found = np.where((found == 0) & same, k, found)
        if (found > 0).all():
            break
    return found


def test_constrained_system_matches_jax(ligand):
    """HBonds with hydrogen mass 4: the same pairs and lengths, the same
    repartitioned inverse masses and the same remaining bonds, exactly."""
    lig, _, js, ts = ligand
    jc, tc = js.constraints, ts.constraints
    assert tc.num_constraints == jc.num_constraints > 0
    np.testing.assert_array_equal(tc.idx.numpy(), np.asarray(jc.idx))
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_array_equal(tc.inv_mass.numpy(),
                                  np.asarray(jc.inv_mass))
    for f in ("bond_idx", "bond_k", "bond_r0"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    assert len(ts.bond_idx) + tc.num_constraints == len(lig.bond_idx)
    # a heavy atom in several constraints (the scatter's duplicates)
    counts = np.bincount(tc.idx.numpy().reshape(-1))
    assert counts.max() >= 2
    for alias, which in (("AllBonds", "all_bonds"), ("h_bonds", "h_bonds")):
        a = system.system_from_amber(lig, constraints=alias, device="cpu")
        b = jsystem.system_from_amber(lig, constraints=which)
        np.testing.assert_array_equal(a.constraints.idx.numpy(),
                                      np.asarray(b.constraints.idx))
        np.testing.assert_array_equal(a.bond_idx.numpy(),
                                      np.asarray(b.bond_idx))
    with pytest.raises(ValueError):
        constraints.constraints_from_bonds(lig.bond_idx, lig.bond_r0,
                                           lig.masses, which="angles")


def test_constraints_from_arrays(ligand):
    _, _, js, ts = ligand
    arrays = {f: np.asarray(getattr(js, f)) for f in convert.SYSTEM_FIELDS}
    got = convert.system_from_arrays(
        arrays, constraints={f: np.asarray(getattr(js.constraints, f))
                             for f in convert.CONSTRAINT_FIELDS},
        device="cpu")
    for f in convert.CONSTRAINT_FIELDS:
        assert torch.equal(getattr(got.constraints, f),
                           getattr(ts.constraints, f))
    assert convert.system_from_arrays(arrays, device="cpu").constraints \
        is None


@pytest.mark.parametrize("lead", [(), (R,)], ids=["single", "replicas"])
@pytest.mark.parametrize("tol,max_iter", [(1e-5, 150), (0.0, 7)],
                         ids=["converged", "max_iter"])
def test_shake_matches_jax(ligand, lead, tol, max_iter):
    """tol 0 never converges: every replica runs exactly max_iter sweeps,
    a count that is no multiple of the host's check block."""
    _, _, js, ts = ligand
    x_ref, x_new = _pair(ligand, 1, 0.004, lead)
    one = jax.jit(lambda a, b, k: jcons.apply_shake(js.constraints, a, b,
                                                    tol=tol, max_iter=k),
                  static_argnums=2)
    fn = (lambda k: jax.vmap(lambda a, b: one(a, b, k))(x_ref, x_new)) \
        if lead else (lambda k: one(x_ref, x_new, k))
    ref = fn(max_iter)
    got, sweeps = constraints.apply_shake(
        ts.constraints, torch.from_numpy(x_ref), torch.from_numpy(x_new),
        tol=tol, max_iter=max_iter)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(sweeps.numpy(),
                                  jax_sweeps(fn, max_iter, ref))
    if tol == 0.0:
        assert (sweeps.numpy() == max_iter).all()
    else:
        assert 1 < sweeps.numpy().min() and sweeps.numpy().max() < max_iter
        if lead:
            assert len(np.unique(sweeps.numpy())) > 1, \
                "replicas should stop at different sweeps"
        # the constraints hold to the tolerance
        idx = ts.constraints.idx
        d = got[..., idx[:, 0], :] - got[..., idx[:, 1], :]
        rel = ((d * d).sum(-1) / ts.constraints.length ** 2 - 1.0).abs()
        assert float(rel.max()) < 10 * tol


@pytest.mark.parametrize("lead", [(), (R,)], ids=["single", "replicas"])
def test_rattle_matches_jax(ligand, lead):
    _, _, js, ts = ligand
    x, _ = _pair(ligand, 2, 0.0, lead)
    v = np.random.default_rng(3).standard_normal(x.shape)
    one = jax.jit(lambda a, b, k: jcons.apply_rattle(js.constraints, a, b,
                                                     max_iter=k),
                  static_argnums=2)
    fn = (lambda k: jax.vmap(lambda a, b: one(a, b, k))(x, v)) \
        if lead else (lambda k: one(x, v, k))
    ref = fn(100)
    got, sweeps = constraints.apply_rattle(
        ts.constraints, torch.from_numpy(x), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(sweeps.numpy(), jax_sweeps(fn, 100, ref))
    assert sweeps.numpy().max() < 100


def test_sweep_stats_count_every_call(ligand):
    _, _, _, ts = ligand
    x_ref, x_new = _pair(ligand, 4, 0.004)
    stats = constraints.apply_shake.stats
    stats.reset()
    _, a = constraints.apply_shake(ts.constraints, torch.from_numpy(x_ref),
                                   torch.from_numpy(x_new))
    _, b = constraints.apply_shake(ts.constraints, torch.from_numpy(x_ref),
                                   torch.from_numpy(x_new), max_iter=3)
    out = stats.summary()
    assert out["calls"] == 2
    assert out["max_sweeps"] == int(a.max())
    assert out["mean_sweeps"] == pytest.approx(
        (float(a.sum()) + float(b.sum())) / (2 * R))
    # a call executes as many sweeps as its slowest replica runs
    assert out["max_executed"] == int(a.max())
    assert out["mean_executed"] == (int(a.max()) + 3) / 2
    assert (b == 3).all()
    stats.reset()
    assert stats.summary() == {"calls": 0}


@pytest.mark.parametrize("kind", ["shake", "rattle"])
def test_sweep_stats_executed_is_the_slowest_replicas_count(ligand, kind):
    """``executed`` is each call's slowest replica's own sweep count, not
    rounded up to blocks of sweeps, on replicas that stop at other
    sweeps."""
    _, _, _, ts = ligand
    counts = []
    fn = getattr(constraints, f"apply_{kind}")
    fn.stats.reset()
    for seed in (11, 12, 13):
        x_ref, x_new = (torch.from_numpy(a) for a in
                        _pair(ligand, seed, 0.004, lead=(3 * R,)))
        if kind == "shake":
            _, sweeps = fn(ts.constraints, x_ref, x_new)
        else:
            v = torch.from_numpy(np.random.default_rng(seed).standard_normal(
                x_ref.shape))
            _, sweeps = fn(ts.constraints, x_ref, v)
        counts.append(sweeps)
    out = fn.stats.summary()
    slowest = [int(c.max()) for c in counts]
    assert any(int(c.min()) < int(c.max()) for c in counts)
    assert out["calls"] == 3
    assert out["mean_executed"] == sum(slowest) / 3
    assert out["max_executed"] == out["max_sweeps"] == max(slowest)
    assert out["mean_sweeps"] == pytest.approx(
        sum(float(c.sum()) for c in counts) / (9 * R))
    fn.stats.reset()
