"""Port reference-layout evaluation (openmmgridforce_tpu_torch.ops.
interpolate.evaluate_grid) vs the JAX package at float64: the four methods,
atoms inside and outside the box, RUNTIME and STORED inverse power."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmgridforce_tpu.grid import Grid as JGrid
from openmmgridforce_tpu.ops import interpolate as jinterp
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.mm import system
from openmmgridforce_tpu_torch.ops import basis, interpolate

torch.set_num_threads(1)

COUNTS = (7, 8, 9)
SPACING = (0.1, 0.12, 0.09)
ORIGIN = (-0.3, 0.1, 0.2)
N_ATOMS = 23


def _grids(seed, method, mode):
    """A JAX Grid and the port's, from the same random 27-slot data; the
    values are positive when an inverse power is on."""
    rng = np.random.default_rng(seed)
    derivs = rng.standard_normal(COUNTS + (27,)) * 20.0
    derivs[..., 0] *= 2.5
    if mode:
        derivs[..., 0] = np.abs(derivs[..., 0]) + 1.0
    kw = dict(interp_method=method, inv_power_mode=mode,
              inv_power=3.0 if mode else 0.0, oob_k=500.0)
    jg = JGrid.create(derivs[..., 0], SPACING, ORIGIN, derivs=derivs,
                      dtype=jnp.float64, **kw)
    tg = convert.grid_from_arrays(derivs[..., 0], SPACING, ORIGIN,
                                  derivs=derivs, device="cpu", **kw)
    return jg, tg


def _positions(seed, lead=()):
    """Atoms inside the box, plus some outside on every side."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(ORIGIN)
    hi = lo + np.asarray(SPACING) * (np.asarray(COUNTS) - 1)
    return rng.uniform(lo - 0.15, hi + 0.15, lead + (N_ATOMS, 3))


def _scaling(seed):
    s = np.random.default_rng(seed).uniform(-1.0, 1.0, N_ATOMS)
    s[::5] = 0.0                                  # zero scalings included
    return s


@pytest.mark.parametrize("method", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_evaluate_grid_matches_jax(method, mode):
    """1e-10: the same float64 arithmetic in another order."""
    jg, tg = _grids(60 + 3 * method + mode, method, mode)
    x = _positions(61, lead=(2,))
    s = _scaling(62)
    got = interpolate.evaluate_grid(tg, torch.from_numpy(x), s)
    lo = np.asarray(ORIGIN)
    hi = lo + np.asarray(SPACING) * (np.asarray(COUNTS) - 1)
    inside = ((x >= lo) & (x <= hi)).all(-1)
    assert inside.any() and (~inside).any()
    for r in range(x.shape[0]):
        ref = jinterp.evaluate_grid(jg, jnp.asarray(x[r]), s)
        one = interpolate.evaluate_grid(tg, torch.from_numpy(x[r]), s)
        for a, b, c in zip(got, ref, one):
            scale = max(1.0, float(np.abs(np.asarray(b)).max()))
            np.testing.assert_allclose(a[r].numpy(), np.asarray(b),
                                       rtol=1e-10, atol=1e-10 * scale)
            np.testing.assert_allclose(c.numpy(), a[r].numpy(), rtol=1e-13,
                                       atol=1e-13 * scale)
    assert float(got.per_atom_energy[0][~inside[0]].abs().min()) > 0.0


@pytest.mark.parametrize("method,mode", [(0, 0), (1, 2), (2, 1), (3, 0),
                                         (3, 2)])
def test_forces_are_minus_the_energy_gradient(method, mode):
    _, tg = _grids(70 + method, method, mode)
    x = torch.from_numpy(_positions(71)).requires_grad_(True)
    s = _scaling(72)
    res = interpolate.evaluate_grid(tg, x, s)
    (grad,) = torch.autograd.grad(interpolate.grid_energy(tg, x, s), x)
    scale = float(res.forces.detach().abs().max())
    np.testing.assert_allclose(res.forces.detach().numpy(), -grad.numpy(),
                               rtol=1e-9, atol=1e-10 * scale)


@pytest.mark.parametrize("name", ["bspline_derivs", "hermite3_weights",
                                  "hermite3_derivs", "hermite5_weights",
                                  "hermite5_derivs"])
def test_basis_families_match_jax(name):
    from openmmgridforce_tpu.ops import basis as jbasis
    t = np.random.default_rng(5).uniform(0.0, 1.0, (4, 6))
    ref = np.asarray(getattr(jbasis, name)(jnp.asarray(t)))
    got = getattr(basis, name)(torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-15)


def test_grid_binding_dispatches_to_evaluate_grid():
    """A GridBinding may hold an unpacked Grid: mm.system evaluates it in
    the reference layout, as the JAX package does."""
    jg, tg = _grids(80, 3, 0)
    x = _positions(81, lead=(2,))
    s = _scaling(82)
    gb = system.GridBinding(grid=tg, scaling=torch.from_numpy(s))
    e = system.grid_energy([gb], torch.from_numpy(x))
    ref = [float(jinterp.grid_energy(jg, jnp.asarray(x[r]), s))
           for r in range(2)]
    np.testing.assert_allclose(e.numpy(), ref, rtol=1e-10)
    with pytest.raises(TypeError, match="cannot evaluate"):
        system.grid_energy([system.GridBinding(grid=object(), scaling=s)],
                           torch.from_numpy(x))


def test_hermite_methods_need_derivatives():
    _, tg = _grids(90, 2, 0)
    bare = convert.grid_from_arrays(tg.vals.numpy(), SPACING, ORIGIN,
                                    interp_method=2, device="cpu")
    with pytest.raises(ValueError, match="precomputed derivatives"):
        interpolate.evaluate_grid(bare, torch.from_numpy(_positions(91)),
                                  _scaling(92))
    with pytest.raises(ValueError, match=r"\(\+27\)"):
        convert.grid_from_arrays(tg.vals.numpy(), SPACING, ORIGIN,
                                 derivs=np.zeros((3, 3, 3, 27)),
                                 device="cpu")
