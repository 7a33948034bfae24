"""The port's double-float32 tier (ops/twofloat.py, ops/compensated.py)
against the JAX package's modules on the same numpy-seeded inputs, on the
CPU, at the tolerances of tests/test_compensated.py: the error-free
transforms exact (2Sum) or within 1e-13 relative, the compensated
evaluation within 2e-6 of the float64 evaluation (and of the JAX tier).

The JAX functions run op by op (``jax.disable_jit``): every operation is
then its own computation, rounded as the port's eager operations are, so
the transforms agree bit for bit (a jitted fusion may contract a multiply
and an add), and XLA:CPU's minutes of compiling the deep double-word
expressions are skipped."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmgridforce_tpu.grid import Grid as JGrid
from openmmgridforce_tpu.ops import compensated as jcomp
from openmmgridforce_tpu.ops import twofloat as jtf
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.grid import InterpolationMethod, InvPowerMode
from openmmgridforce_tpu_torch.ops import gridgen
from openmmgridforce_tpu_torch.ops import twofloat as tf
from openmmgridforce_tpu_torch.ops.compensated import (
    evaluate_compensated, pack_grid_compensated)
from openmmgridforce_tpu_torch.ops.interpolate import evaluate_grid
from openmmgridforce_tpu_torch.ops.packed import evaluate_packed, pack_grid

torch.set_num_threads(1)

COUNTS = (6, 7, 8)
SPACING = (0.11, 0.09, 0.13)
ORIGIN = (0.5, -0.2, 0.3)


def _f64(pair):
    return np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)


def _pairs(x64):
    hi, lo = tf.df_from_f64(x64)
    return (torch.from_numpy(hi), torch.from_numpy(lo)), \
        (jnp.asarray(hi), jnp.asarray(lo))


def _same(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ----------------------------------------------------------------------
# error-free transforms and double-word operations
# ----------------------------------------------------------------------

def test_two_sum_and_two_prod():
    rng = np.random.default_rng(77)
    a = (rng.standard_normal(1000) * 1e6).astype(np.float32)
    b = (rng.standard_normal(1000) * 1e-3).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    s = tf.two_sum(ta, tb)
    np.testing.assert_array_equal(_f64(s), a.astype(np.float64)
                                  + b.astype(np.float64))
    with jax.disable_jit():
        _same(s, jtf.two_sum(jnp.asarray(a), jnp.asarray(b)))
    a = (rng.standard_normal(1000) * 1e4).astype(np.float32)
    b = (rng.standard_normal(1000) * 1e-2).astype(np.float32)
    p = tf.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_allclose(_f64(p), exact, rtol=1e-13)
    np.testing.assert_allclose(p[0].numpy().astype(np.float64), exact,
                               rtol=1.3e-7)
    with jax.disable_jit():
        _same(p, jtf.two_prod(jnp.asarray(a), jnp.asarray(b)))
        # the split's halves carry 12 significand bits and add back exactly
        hi, lo = tf.bitmask_split(torch.from_numpy(a))
        _same((hi, lo), jtf.bitmask_split(jnp.asarray(a)))
    np.testing.assert_array_equal((hi + lo).numpy(), a)


def test_df_mul_add_and_constant_operand():
    rng = np.random.default_rng(78)
    x64 = rng.standard_normal(500) * 1e5
    y64 = rng.standard_normal(500)
    (tx, jx), (ty, jy) = _pairs(x64), _pairs(y64)
    for fn, jfn, want in ((tf.df_mul, jtf.df_mul, x64 * y64),
                          (tf.df_add, jtf.df_add, x64 + y64),
                          (tf.df_sub, jtf.df_sub, x64 - y64)):
        got = fn(tx, ty)
        np.testing.assert_allclose(_f64(got), want, rtol=1e-13)
        with jax.disable_jit():
            _same(got, jfn(jx, jy))
    c64 = 1.0 / 50.0
    c = tf.df(torch.full_like(tx[0], np.float32(c64)),
              torch.full_like(tx[0], np.float32(c64 - np.float64(
                  np.float32(c64)))))
    np.testing.assert_allclose(_f64(tf.df_mul(tx, c)), x64 * c64,
                               rtol=1e-13)
    b = (rng.standard_normal(500) * 3.0).astype(np.float32)
    for fn, want in ((tf.df_mul_f, x64 * b.astype(np.float64)),
                     (tf.df_add_f, x64 + b.astype(np.float64))):
        np.testing.assert_allclose(_f64(fn(tx, torch.from_numpy(b))), want,
                                   rtol=1e-13)


def test_df_sum_tree_reduction():
    """Odd lengths (zero padding) and mixed magnitudes a plain float32 sum
    would lose; a batch axis reduces row by row."""
    rng = np.random.default_rng(21)
    for n in (1, 2, 7, 1000, 4097):
        x64 = rng.standard_normal(n) * 1e6 + rng.standard_normal(n) * 1e-3
        t, j = _pairs(x64)
        got = _f64(tf.df_sum(t))
        want = x64.sum()
        denom = max(abs(want), np.abs(x64).sum() * 1e-6)
        assert abs(got - want) / denom < 1e-11, (n, got, want)
        with jax.disable_jit():
            _same(tf.df_sum(t), jtf.df_sum(j))
    rows = rng.standard_normal((3, 37)) * 1e4
    t, _ = _pairs(rows)
    np.testing.assert_allclose(_f64(tf.df_sum(t)), rows.sum(-1), rtol=1e-13)


# ----------------------------------------------------------------------
# compensated evaluation
# ----------------------------------------------------------------------

def _positions(rng, n=60):
    lo = np.asarray(ORIGIN)
    hi = lo + (np.asarray(COUNTS) - 1) * np.asarray(SPACING)
    pts = [rng.uniform(lo - 0.1, hi + 0.1, size=(n, 3)),
           lo + np.array([[0, 0, 0], [1, 2, 3], [4, 5, 6]])
           * np.asarray(SPACING),
           np.array([hi, lo, [hi[0], lo[1], hi[2]]])]
    return np.concatenate(pts)


@pytest.mark.parametrize("method,mode,n", [
    (InterpolationMethod.TRILINEAR, InvPowerMode.NONE, 0.0),
    (InterpolationMethod.BSPLINE, InvPowerMode.NONE, 0.0),
    (InterpolationMethod.BSPLINE, InvPowerMode.STORED, 3.0),
    (InterpolationMethod.BSPLINE, InvPowerMode.RUNTIME, 2.0),
    (InterpolationMethod.TRICUBIC, InvPowerMode.NONE, 0.0),
    (InterpolationMethod.TRIQUINTIC, InvPowerMode.NONE, 0.0),
    (InterpolationMethod.TRIQUINTIC, InvPowerMode.STORED, 2.0),
])
def test_compensated_matches_f64_and_jax(method, mode, n):
    rng = np.random.default_rng(77 + int(method) + 3 * int(mode))
    vals = np.abs(rng.standard_normal(COUNTS)) + 0.5
    hermite = method in (InterpolationMethod.TRICUBIC,
                         InterpolationMethod.TRIQUINTIC)
    derivs = None
    if hermite:
        derivs = rng.standard_normal(COUNTS + (27,))
        derivs[..., 0] = vals
    kw = dict(interp_method=int(method), inv_power_mode=int(mode),
              inv_power=n, oob_k=777.0)
    grid = convert.grid_from_arrays(vals, SPACING, ORIGIN, derivs=derivs,
                                    device="cpu", **kw)
    jgrid = JGrid.create(vals, SPACING, ORIGIN, derivs=derivs,
                         dtype=np.float64, **kw)
    cp = pack_grid_compensated(grid)
    assert cp.coeffs.dtype == torch.float32
    assert cp.cell_counts == tuple(c - 1 for c in COUNTS)

    pos = _positions(rng)
    scaling = rng.standard_normal(len(pos))
    scaling[3] = 0.0
    ref = evaluate_grid(grid, torch.from_numpy(pos), scaling)
    got = evaluate_compensated(cp, pos, scaling)
    with jax.disable_jit():
        jgot = jcomp.evaluate_compensated(
            jcomp.pack_grid_compensated(jgrid), pos, scaling)

    ref_pa = ref.per_atom_energy.numpy()
    scale = np.abs(ref_pa).max()
    for pa in (got.per_atom_energy.numpy().astype(np.float64),
               np.asarray(jgot.per_atom_energy, np.float64)):
        np.testing.assert_allclose(pa, ref_pa, rtol=2e-6, atol=2e-6 * scale)
    # forces away from cell boundaries, where the gradient jumps and the
    # cell an atom lands in is a tie between the float64 division and the
    # df arithmetic
    t = (pos - np.asarray(ORIGIN)) / np.asarray(SPACING)
    off_node = (np.abs(t - np.round(t)) > 1e-9).all(axis=1)
    fscale = np.abs(ref.forces.numpy()).max()
    for f in (got.forces.numpy(), np.asarray(jgot.forces)):
        np.testing.assert_allclose(f.astype(np.float64)[off_node],
                                   ref.forces.numpy()[off_node], rtol=2e-6,
                                   atol=2e-6 * fscale)
    assert float(got.energy) == pytest.approx(float(ref.energy), rel=1e-6,
                                              abs=2e-6 * scale * len(pos))
    assert float(got.energy) == pytest.approx(float(jgot.energy), rel=1e-6,
                                              abs=2e-6 * scale * len(pos))


def _steep_grid(method, counts=(12, 12, 12), spacing=0.05):
    """A receptor-core-like capped field, the float32 stressor."""
    rng = np.random.default_rng(7)
    rec = rng.uniform(0.15, 0.85 * (counts[0] - 1) * spacing, (12, 3))
    q = rng.uniform(0.05, 0.5, 12)
    return gridgen.generate_grid(
        counts, (spacing,) * 3, (0.0,) * 3, "lja", rec, q, np.full(12, 0.3),
        np.full(12, 0.6), interp_method=method,
        compute_derivatives=method == InterpolationMethod.TRIQUINTIC,
        dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("method", [InterpolationMethod.BSPLINE,
                                    InterpolationMethod.TRIQUINTIC])
def test_compensated_breaks_the_f32_floor(method):
    """On a steep capped field the tier sits at its design floor (< 1.5e-7
    of the field's scale) and at least 3x under plain float32, against the
    float64 stencil on the same float32-stored data."""
    g64 = _steep_grid(method)
    reps = {"vals": g64.vals.float(), "spacing": g64.spacing.float(),
            "origin": g64.origin.float()}
    if g64.derivs is not None:
        reps["derivs"] = g64.derivs.float()
    g32 = g64.with_(**reps)
    g64c = g64.with_(**{k: v.double() for k, v in reps.items()})
    rng = np.random.default_rng(9)
    pos = rng.uniform(0.02, 0.5, (300, 3))
    scal = np.ones(300)
    truth = evaluate_grid(g64c, torch.from_numpy(pos), scal)
    truth = truth.per_atom_energy.numpy()
    scale = np.abs(truth).max()
    plain = evaluate_packed(pack_grid(g32), torch.from_numpy(pos).float(),
                            scal.astype(np.float32))
    err_plain = np.abs(plain.per_atom_energy.numpy() - truth).max()
    comp = evaluate_compensated(pack_grid_compensated(g32), pos, scal)
    err_comp = np.abs(comp.per_atom_energy.numpy() - truth).max()
    assert err_comp / scale < 1.5e-7, (err_comp, scale)
    assert err_comp * 3 < err_plain, (err_comp, err_plain)


def test_compensated_f32_positions_restraint_and_batches():
    """float32 positions (zero low words) against float64 truth; the
    restraint and scaling-0 semantics of evaluate_grid; a [R, N, 3] batch
    equals its replicas one by one, energies per replica."""
    g64 = _steep_grid(InterpolationMethod.BSPLINE)
    cp = pack_grid_compensated(g64)
    rng = np.random.default_rng(10)
    pos32 = rng.uniform(0.05, 0.45, (100, 3)).astype(np.float32)
    truth = evaluate_grid(g64, torch.from_numpy(pos32).double(),
                          np.ones(100)).per_atom_energy.numpy()
    got = evaluate_compensated(cp, pos32, np.ones(100, np.float32))
    assert np.abs(got.per_atom_energy.numpy() - truth).max() \
        / np.abs(truth).max() < 1e-6

    vals = np.random.default_rng(11).standard_normal(COUNTS)
    grid = convert.grid_from_arrays(vals, SPACING, ORIGIN, interp_method=1,
                                    oob_k=1234.0, device="cpu")
    cp = pack_grid_compensated(grid)
    lo = np.asarray(ORIGIN)
    hi = lo + (np.asarray(COUNTS) - 1) * np.asarray(SPACING)
    pos = np.stack([lo - 0.25, hi + 0.4, lo + 0.5 * (hi - lo)])
    scal = np.array([1.0, 2.0, 0.0])
    ref = evaluate_grid(grid, torch.from_numpy(pos), scal)
    res = evaluate_compensated(cp, pos, scal)
    np.testing.assert_allclose(res.per_atom_energy.numpy(),
                               ref.per_atom_energy.numpy(), rtol=1e-6)
    np.testing.assert_allclose(res.forces.numpy(), ref.forces.numpy(),
                               rtol=1e-6)

    batch = rng.uniform(lo - 0.05, hi + 0.05, (4, 20, 3))
    s = rng.standard_normal(20)
    whole = evaluate_compensated(cp, batch, s)
    singles = [evaluate_compensated(cp, batch[r], s) for r in range(4)]
    np.testing.assert_array_equal(
        whole.per_atom_energy.numpy(),
        np.stack([x.per_atom_energy.numpy() for x in singles]))
    np.testing.assert_array_equal(whole.forces.numpy(),
                                  np.stack([x.forces.numpy()
                                            for x in singles]))
    np.testing.assert_array_equal(whole.energy.numpy(),
                                  np.stack([x.energy.numpy()
                                            for x in singles]))


def test_compensated_exact_geometry_override():
    """A float32 Grid's rounded origin and spacing shift the fraction at
    large cell coordinates; pack_grid_compensated(origin=, spacing=)
    restores the design floor."""
    spacing = 0.0125
    counts = (96, 8, 8)
    origin = (1.00175115, 0.5328844699999999, 0.8606374500000002)
    rng = np.random.default_rng(5)
    rec = rng.uniform(0.3, 0.9, (8, 3)) + np.asarray(origin)
    rec[:, 0] += 0.7
    g64 = gridgen.generate_grid(counts, (spacing,) * 3, origin, "lja", rec,
                                rng.uniform(0.05, 0.5, 8), np.full(8, 0.3),
                                np.full(8, 0.6), dtype=torch.float64,
                                interp_method=1, device="cpu")
    g32 = g64.with_(vals=g64.vals.float(), spacing=g64.spacing.float(),
                    origin=g64.origin.float())
    g64c = g64.with_(vals=g32.vals.double())
    pos = np.stack([rng.uniform(origin[0] + 0.9, origin[0] + 1.15, 60),
                    rng.uniform(origin[1] + 0.02, origin[1] + 0.06, 60),
                    rng.uniform(origin[2] + 0.02, origin[2] + 0.06, 60)],
                   axis=1)
    scal = np.ones(60)
    truth = evaluate_grid(g64c, torch.from_numpy(pos),
                          scal).per_atom_energy.numpy()
    scale = np.abs(truth).max()
    rounded = evaluate_compensated(pack_grid_compensated(g32), pos, scal)
    exact = evaluate_compensated(
        pack_grid_compensated(g32, origin=origin, spacing=(spacing,) * 3),
        pos, scal)
    err_rounded = np.abs(rounded.per_atom_energy.numpy() - truth).max()
    err_exact = np.abs(exact.per_atom_energy.numpy() - truth).max()
    assert err_exact / scale < 1.5e-7, (err_exact, scale)
    assert err_rounded > 3 * err_exact, (err_rounded, err_exact)
