"""Port compat API vs the JAX package: stepping through a Context, on
the CPU in float64.

Verlet (with and without HBonds constraints) and both Langevin schemes at
T = 0, where the noise term vanishes, follow JAX's trajectories to 1e-9 nm
over 50 steps. The two packages draw different random numbers, so a
Langevin trajectory at 300 K is held only to its own reproducibility, and
``setTemperature`` to the trajectory of an integrator made at the new
temperature. Helpers and grids: ``test_torch_api.py``."""

import numpy as np
import pytest

from test_torch_api import (jgfp, ligand_context, tgfp,  # noqa: F401
                            world)

N_STEPS = 50

INTEGRATORS = {
    "verlet": (lambda g: g.VerletIntegrator(0.001), None),
    "verlet_hbonds": (lambda g: g.VerletIntegrator(0.001), "HBonds"),
    "langevin_t0": (lambda g: g.LangevinIntegrator(0.0, 5.0, 0.001), None),
    "middle_t0_hbonds": (
        lambda g: g.LangevinMiddleIntegrator(0.0, 5.0, 0.002), "HBonds"),
}


def _velocities(w):
    return np.random.default_rng(2).normal(0.0, 0.5, w["x"].shape)


@pytest.mark.parametrize("name", list(INTEGRATORS))
def test_stepping_matches_jax(world, name):
    integrator, constraints = INTEGRATORS[name]
    ctxs = {}
    for g in (tgfp, jgfp):
        ctx = ligand_context(g, world, 1, "CUDA", integrator=integrator(g),
                             constraints=constraints, hydrogen_mass=4.0)
        ctx.setVelocities(_velocities(world))
        ctx.getIntegrator().step(N_STEPS)
        ctxs[g] = ctx
    st = {g: c.getState(getPositions=True, getVelocities=True)
          for g, c in ctxs.items()}
    np.testing.assert_allclose(st[tgfp].getPositions(),
                               np.asarray(st[jgfp].getPositions()),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(st[tgfp].getVelocities(),
                               np.asarray(st[jgfp].getVelocities()),
                               rtol=0, atol=1e-6)
    if constraints:
        core = ctxs[tgfp].system._core
        idx = core.constraints.idx.numpy()
        x = st[tgfp].getPositions()
        d = np.linalg.norm(x[idx[:, 0]] - x[idx[:, 1]], axis=1)
        np.testing.assert_allclose(d, core.constraints.length.numpy(),
                                   rtol=1e-6)


def _langevin(w, temperature):
    return ligand_context(tgfp, w, 1, "CUDA",
                          integrator=tgfp.LangevinIntegrator(temperature,
                                                             5.0, 0.002),
                          constraints="HBonds", hydrogen_mass=4.0)


def test_langevin_300k_reproducible(world):
    """One seed twice gives one trajectory; another seed another; the
    kinetic energy is finite and the constraints hold."""
    runs = []
    for seed in (7, 7, 8):
        ctx = _langevin(world, 300.0)
        ctx.setVelocitiesToTemperature(300.0, seed=seed)
        ctx.getIntegrator().step(40)
        runs.append(ctx)
    a, b, c = runs
    np.testing.assert_array_equal(a.getPositions(), b.getPositions())
    assert not np.array_equal(a.getPositions(), c.getPositions())
    st = a.getState(getEnergy=True)
    assert np.isfinite(st.getKineticEnergy()) and st.getKineticEnergy() > 0
    cs = a.system._core.constraints
    x = a.getPositions()
    idx = cs.idx.numpy()
    d = np.linalg.norm(x[idx[:, 0]] - x[idx[:, 1]], axis=1)
    np.testing.assert_allclose(d, cs.length.numpy(), rtol=1e-6)


def test_set_temperature_takes_effect(world):
    """setTemperature on an integrator already bound to a Context gives the
    trajectory of an integrator made at the new temperature, and not the
    old one's; also between two runs of steps."""
    def run(made_at, set_to=None, first=0):
        ctx = _langevin(world, made_at)
        ctx.setVelocitiesToTemperature(0.0, seed=9)
        ctx.getIntegrator().step(first)
        if set_to is not None:
            ctx.getIntegrator().setTemperature(set_to)
        ctx.getIntegrator().step(30 - first)
        return ctx.getPositions()

    moved, made, old = run(300.0, 50.0), run(50.0), run(300.0)
    np.testing.assert_array_equal(moved, made)
    assert not np.allclose(old, moved)
    assert not np.allclose(run(50.0, 300.0, first=10), made)


def test_dropping_the_context_frees_its_stepper_and_its_grids(world):
    """The forces and the integrator hold their Context weakly, so a
    dropped Context, its stepper and the grids it resolved are freed at
    once, with no garbage collection, while the forces and the system
    live on."""
    import gc
    import weakref

    integrator = tgfp.VerletIntegrator(0.001)
    ctx = ligand_context(tgfp, world, 1, "CUDA", integrator=integrator)
    ctx.setVelocities(_velocities(world))
    integrator.step(5)
    force = ctx.system.getForces()[4]
    assert force._context is ctx and integrator._context is ctx
    refs = [weakref.ref(o) for o in (ctx, ctx._segment, ctx._terms,
                                     ctx._grid_infos[4].grid.vals)]
    enabled = gc.isenabled()
    gc.disable()
    try:
        del ctx
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        if enabled:
            gc.enable()
    assert force._context is None and integrator._context is None
    assert force.getParticleGroupEnergies() == []
    with pytest.raises(RuntimeError, match="no live Context"):
        integrator.step(1)


def test_update_parameters_drops_the_stepper_and_its_grids(world):
    """updateParametersInContext re-resolves the forces and drops the
    stepper: the old resolved terms (and the grids they hold) are freed
    at once, with no reference cycle waiting for a garbage collection,
    and the next steps read the new grids."""
    import weakref

    ctx = ligand_context(tgfp, world, 1, "CUDA",
                         integrator=tgfp.VerletIntegrator(0.001))
    ctx.setVelocities(_velocities(world))
    ctx.getIntegrator().step(5)
    assert ctx._segment is not None
    old_terms = weakref.ref(ctx._terms)
    old_grid = weakref.ref(ctx._grid_infos[4].grid.vals)
    force = ctx.system.getForces()[4]
    force.setGridValues(2.0 * np.asarray(force.getGridValues()))
    force.updateParametersInContext(ctx)
    assert ctx._segment is None
    assert old_terms() is None and old_grid() is None
    st = ctx.getState(getPositions=True, getVelocities=True)
    ctx.getIntegrator().step(5)
    fresh = ligand_context(
        tgfp, world, 1, "CUDA", integrator=tgfp.VerletIntegrator(0.001),
        configure=lambda i, f: (f.setGridValues(
            2.0 * np.asarray(f.getGridValues())) if i == 0 else None))
    fresh.setPositions(st.getPositions())
    fresh.setVelocities(st.getVelocities())
    fresh.getIntegrator().step(5)
    np.testing.assert_array_equal(fresh.getPositions(), ctx.getPositions())
