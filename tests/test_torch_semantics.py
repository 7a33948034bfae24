"""The alternate kernel semantics of the port (ops/common_semantics.py,
ops/reference_semantics.py) against the JAX package's modules on the same
numpy-seeded inputs, in float64 on the CPU, at the tolerances of
tests/test_common_semantics.py and tests/test_reference_semantics.py
(1e-12, the reference's forces 1e-10). The Context-level cases (the
platforms of the compat API) wait for its port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmgridforce_tpu.grid import Grid as JGrid
from openmmgridforce_tpu.ops import common_semantics as jcommon
from openmmgridforce_tpu.ops import reference_semantics as jref
from openmmgridforce_tpu.ops.gridgen import generate_grid as jgenerate
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.grid import InterpolationMethod
from openmmgridforce_tpu_torch.ops.common_semantics import (
    evaluate_grid_common)
from openmmgridforce_tpu_torch.ops.interpolate import evaluate_grid
from openmmgridforce_tpu_torch.ops.reference_semantics import (
    evaluate_grid_reference)

from test_reference_semantics import oracle_execute

torch.set_num_threads(1)

OOB_K = 10000.0


def _both(vals, spacing, origin, derivs=None, **kw):
    jg = JGrid.create(vals, spacing, origin, derivs=derivs, dtype=np.float64,
                      **kw)
    tg = convert.grid_from_arrays(vals, spacing, origin, derivs=derivs,
                                  device="cpu", **kw)
    return jg, tg


def _close(got, ref, e_rtol=1e-12, f_rtol=1e-12, f_atol=1e-12):
    np.testing.assert_allclose(got.per_atom_energy.numpy(),
                               np.asarray(ref.per_atom_energy), rtol=e_rtol,
                               atol=1e-12)
    np.testing.assert_allclose(float(got.energy), float(ref.energy),
                               rtol=e_rtol)
    np.testing.assert_allclose(got.forces.numpy(), np.asarray(ref.forces),
                               rtol=f_rtol, atol=f_atol)


# ----------------------------------------------------------------------
# Common platform (Q6)
# ----------------------------------------------------------------------

C_COUNTS, C_SPACING, C_ORIGIN = (9, 9, 9), (0.1, 0.1, 0.1), (0.0,) * 3


@pytest.mark.parametrize("method", [0, 1])
@pytest.mark.parametrize("inv_power", [0.0, 2.0])
def test_common_matches_jax(method, inv_power):
    """Atoms inside, outside on every side and with zero scaling; the
    bare power transform on a positive field."""
    rng = np.random.default_rng(23 + method)
    vals = rng.uniform(0.5, 4.0, C_COUNTS)
    jg, tg = _both(vals, C_SPACING, C_ORIGIN, interp_method=method,
                   inv_power=inv_power, inv_power_mode=2 if inv_power else 0,
                   oob_k=OOB_K)
    pos = rng.uniform(-0.15, 0.95, (30, 3))
    s = rng.uniform(-1.5, 1.5, 30)
    s[::4] = 0.0
    _close(evaluate_grid_common(tg, pos, s),
           jcommon.evaluate_grid_common(jg, pos, s))


def test_common_q6_and_skipped_atoms():
    """Q6: the restraint energy unscaled, its force scaled; a scaling-0
    atom contributes nothing; inside the box, no inverse power, the
    default kernel's result."""
    rng = np.random.default_rng(7)
    _, tg = _both(rng.standard_normal(C_COUNTS) * 3.0, C_SPACING, C_ORIGIN,
                  interp_method=1)
    pos = np.array([[1.0, 0.4, 0.4]])
    res = evaluate_grid_common(tg, pos, np.array([2.5]))
    np.testing.assert_allclose(float(res.per_atom_energy[0]),
                               0.5 * tg.oob_k * 0.2 ** 2, rtol=1e-12)
    np.testing.assert_allclose(res.forces[0].numpy(),
                               [-2.5 * tg.oob_k * 0.2, 0.0, 0.0],
                               rtol=1e-12)
    res0 = evaluate_grid_common(tg, pos, np.array([0.0]))
    assert float(res0.energy) == 0.0 and not res0.forces.any()
    inside = rng.uniform(0.15, 0.65, (12, 3))
    s = rng.uniform(0.5, 1.5, 12)
    _close(evaluate_grid_common(tg, inside, s),
           evaluate_grid(tg, torch.from_numpy(inside), s))


def test_common_rejects_hermite():
    rng = np.random.default_rng(8)
    derivs = rng.standard_normal(C_COUNTS + (27,))
    _, tg = _both(derivs[..., 0], C_SPACING, C_ORIGIN, derivs=derivs,
                  interp_method=2)
    with pytest.raises(ValueError, match="trilinear and B-spline"):
        evaluate_grid_common(tg, np.zeros((1, 3)), np.ones(1))


# ----------------------------------------------------------------------
# Reference platform (Q2, Q4, Q12, FD tricubic, flat reads)
# ----------------------------------------------------------------------

R_COUNTS, R_SPACING, R_ORIGIN = (9, 8, 7), (0.11, 0.09, 0.13), \
    (0.2, -0.1, 0.05)


def _ref_positions(rng, n=40):
    lo = np.asarray(R_ORIGIN)
    hi = lo + (np.asarray(R_COUNTS) - 1) * np.asarray(R_SPACING)
    pos = rng.uniform(lo - 0.05, hi + 0.05, (n, 3))
    pos[0] = hi                    # exact upper face and corner (Q2)
    pos[1] = [hi[0], lo[1] + 0.123, lo[2] + 0.2]
    pos[2] = lo
    pos[3] = [lo[0] + 0.1, hi[1], lo[2] + 0.15]
    return pos


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("inv_power", [0.0, 2.0])
def test_reference_matches_jax_and_the_oracle(method, inv_power):
    """Trilinear, B-spline and the values-only FD tricubic, with the
    literal pow back-transform (Q4) and exact-face atoms (Q2), against
    the JAX module and the scalar port of the C++."""
    rng = np.random.default_rng(31 + method)
    vals = rng.standard_normal(R_COUNTS) + 2.5
    jg, tg = _both(vals, R_SPACING, R_ORIGIN, interp_method=method,
                   inv_power=inv_power, inv_power_mode=2 if inv_power else 0,
                   oob_k=OOB_K)
    pos = _ref_positions(rng)
    scal = rng.uniform(-1.0, 1.0, len(pos))
    scal[5] = 0.0
    got = evaluate_grid_reference(tg, pos, scal)
    _close(got, jref.evaluate_grid_reference(jg, pos, scal), f_rtol=1e-10)
    e_o, f_o = oracle_execute(vals.reshape(-1), R_COUNTS, R_SPACING,
                              R_ORIGIN, scal, pos, method,
                              inv_power=inv_power)
    np.testing.assert_allclose(float(got.energy), e_o, rtol=1e-12)
    np.testing.assert_allclose(got.forces.numpy(), f_o, rtol=1e-10,
                               atol=1e-12)


def test_reference_q2_upper_face():
    """At the exact upper face the reference's unclamped cell reads the
    flat array's next row: the energy agrees with the default kernel, the
    face-normal force does not; inside, both agree."""
    rng = np.random.default_rng(5)
    jg, tg = _both(rng.standard_normal(R_COUNTS) + 2.5, (0.125,) * 3,
                   (0.0,) * 3, interp_method=0, oob_k=OOB_K)
    hi = (np.asarray(R_COUNTS) - 1) * 0.125
    scal = np.array([1.0])
    for pos in (np.array([[hi[0], 0.15, 0.3]]),
                np.array([[0.37, 0.21, 0.33]])):
        got = evaluate_grid_reference(tg, pos, scal)
        _close(got, jref.evaluate_grid_reference(jg, pos, scal))
        cuda = evaluate_grid(tg, torch.from_numpy(pos), scal)
        np.testing.assert_allclose(float(got.energy), float(cuda.energy),
                                   rtol=1e-12)
        same = np.allclose(got.forces.numpy(), cuda.forces.numpy(),
                           rtol=1e-6)
        assert same == (pos[0, 0] != hi[0])


def test_reference_q12_triquintic():
    """The triquintic branch multiplies gradients by the spacing (Q12):
    the value is the default kernel's, the forces that times spacing^2,
    and both equal the JAX module's."""
    rng = np.random.default_rng(12)
    n = 10
    jgrid = jgenerate(R_COUNTS, R_SPACING, R_ORIGIN, "charge",
                      rng.uniform(0.1, 0.9, (n, 3)),
                      rng.uniform(-0.4, 0.4, n), np.full(n, 0.3),
                      np.full(n, 0.5), compute_derivatives=True,
                      interp_method=3, oob_k=OOB_K, dtype=np.float64)
    tg = convert.grid_from_arrays(
        np.asarray(jgrid.vals), R_SPACING, R_ORIGIN,
        derivs=np.asarray(jgrid.derivs), interp_method=3, oob_k=OOB_K,
        device="cpu")
    lo = np.asarray(R_ORIGIN) + 0.05
    hi = np.asarray(R_ORIGIN) + (np.asarray(R_COUNTS) - 1.5) * np.asarray(
        R_SPACING)
    pos = rng.uniform(lo, hi, (15, 3))
    scal = rng.uniform(0.2, 1.0, 15)
    got = evaluate_grid_reference(tg, pos, scal)
    _close(got, jref.evaluate_grid_reference(jgrid, pos, scal),
           f_rtol=1e-10)
    cuda = evaluate_grid(tg, torch.from_numpy(pos), scal)
    np.testing.assert_allclose(got.per_atom_energy.numpy(),
                               cuda.per_atom_energy.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got.forces.numpy(),
                               cuda.forces.numpy() * np.asarray(R_SPACING)
                               ** 2, rtol=1e-10)
    with pytest.raises(ValueError, match="derivatives"):
        evaluate_grid_reference(tg.with_(derivs=None), pos, scal)
