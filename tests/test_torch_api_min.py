"""Port compat API vs the JAX package: minimisation through a Context,
on the CPU in float64.

The port's L-BFGS (``api/lbfgs.py``, the algorithm of ``optax.lbfgs()``)
takes optax's first 10 iterates on the Context's energy to 1e-8 nm, and
``Simulation.minimizeEnergy(150, 20)`` meets the JAX tests' gates and
ends within 1e-4 relative of JAX's energy. Helpers and grids:
``test_torch_api.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from openmmgridforce_tpu_torch.api import lbfgs
from test_torch_api import (jgfp, ligand_context, tgfp,  # noqa: F401
                            world)


def _perturbed(w):
    return w["x"] + np.random.default_rng(5).normal(0.0, 0.004,
                                                    w["x"].shape)


def test_lbfgs_iterates_match_optax(world):
    """The first 10 iterates of api/lbfgs.py against optax.lbfgs() on the
    Context's energy (JAX's value_and_grad of it), to 1e-8 nm."""
    x0 = _perturbed(world)
    jctx = ligand_context(jgfp, world, 1, "CUDA")
    gidx, grids = jctx._grid_arguments()

    def energy(p, grids):
        return jctx._group_mask_terms(p, None, dict(zip(gidx, grids)))[0]

    opt = optax.lbfgs()
    vg = jax.value_and_grad(energy)

    @jax.jit
    def update(x, st, grids):
        e, g = vg(x, grids)
        u, st = opt.update(g, st, x, value=e, grad=g,
                           value_fn=lambda p: energy(p, grids))
        return optax.apply_updates(x, u), st

    x, st = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    want = []
    for _ in range(10):
        x, st = update(x, st, grids)
        want.append(np.asarray(x))

    tctx = ligand_context(tgfp, world, 1, "CUDA")
    tctx.setPositions(x0)
    vg_t = tctx._terms.value_and_grad
    pt = lbfgs.point(tctx._positions, vg_t)
    state = lbfgs.init(pt.x)
    for i in range(10):
        pt, state = lbfgs.minimize_step(state, pt, vg_t)
        np.testing.assert_allclose(pt.x.numpy(), want[i], rtol=0,
                                   atol=1e-8, err_msg=f"iterate {i + 1}")


def test_minimize_energy_matches_jax(world):
    """minimizeEnergy(150, 20.0) from a perturbed pose: the gates of
    tests/test_api.py::test_minimize_energy (e1 < e0, rms < 100) and
    JAX's final energy to 1e-4 relative."""
    out = {}
    for g in (tgfp, jgfp):
        ctx = ligand_context(g, world, 1, "CUDA")
        kw = {"device": "cpu"} if g is tgfp else {}
        sim = g.Simulation(world["lig"], ctx.system, g.VerletIntegrator(0.001),
                           **kw)
        sim.context.setPositions(_perturbed(world))
        e0 = sim.context.getState(getEnergy=True).getPotentialEnergy()
        sim.minimizeEnergy(maxIterations=150, tolerance=20.0)
        st = sim.context.getState(getEnergy=True, getForces=True)
        e1 = st.getPotentialEnergy()
        assert e1 < e0
        rms = float(np.sqrt((np.asarray(st.getForces()) ** 2).mean()))
        assert rms < 100.0
        out[g] = e1
    assert out[tgfp] == pytest.approx(out[jgfp], rel=1e-4)
