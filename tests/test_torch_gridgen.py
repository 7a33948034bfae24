"""Port grid generation (openmmgridforce_tpu_torch.ops.gridgen) vs the JAX
package: the f64 jnp path, and the Pallas kernel in interpret mode for the
f32 plain twin of the CUDA kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmgridforce_tpu.grid import InvPowerMode as JInvPowerMode
from openmmgridforce_tpu.ops import gridgen as jgridgen
from openmmgridforce_tpu.ops.pallas_gridgen import generate_grid_values_pallas
from openmmgridforce_tpu_torch.grid import InvPowerMode
from openmmgridforce_tpu_torch.ops import gridgen

torch.set_num_threads(1)

COUNTS = (9, 10, 11)
SPACING = (0.1, 0.11, 0.09)
ORIGIN = (0.0, -0.2, 0.3)


def _receptor(seed, n=37):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.3, 1.2, (n, 3)), rng.uniform(-1, 1, n),
            rng.uniform(0.2, 0.35, n), rng.uniform(0.1, 1.0, n))


@pytest.mark.parametrize("grid_type,lj_convention", [
    ("charge", "rmin"), ("ljr", "rmin"), ("lja", "rmin"),
    ("ljr", "diameter"), ("lja", "diameter")])
def test_generate_grid_matches_jax_f64(grid_type, lj_convention):
    pos, q, sig, eps = _receptor(1)
    ref = np.asarray(jgridgen.generate_grid(
        COUNTS, SPACING, ORIGIN, grid_type, pos, q, sig, eps,
        grid_cap=800.0, lj_convention=lj_convention, backend="jnp",
        dtype=jnp.float64).vals)
    got = gridgen.generate_grid(
        COUNTS, SPACING, ORIGIN, grid_type, pos, q, sig, eps,
        grid_cap=800.0, lj_convention=lj_convention, dtype=torch.float64,
        device="cpu")
    assert got.counts == COUNTS and got.grid_type == grid_type
    assert np.abs(got.vals.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["RUNTIME", "STORED"])
def test_generate_grid_inv_power_matches_jax_f64(mode):
    pos, q, sig, eps = _receptor(2)
    ref = jgridgen.generate_grid(
        COUNTS, SPACING, ORIGIN, "ljr", pos, q, sig, eps, grid_cap=800.0,
        inv_power=4.0, inv_power_mode=JInvPowerMode[mode], backend="jnp",
        dtype=jnp.float64)
    got = gridgen.generate_grid(
        COUNTS, SPACING, ORIGIN, "ljr", pos, q, sig, eps, grid_cap=800.0,
        inv_power=4.0, inv_power_mode=InvPowerMode[mode],
        dtype=torch.float64, device="cpu")
    ref_v = np.asarray(ref.vals)
    assert np.abs(got.vals.numpy() - ref_v).max() <= 1e-10 * np.abs(
        ref_v).max()
    assert (got.inv_power, got.inv_power_mode) == (ref.inv_power,
                                                   ref.inv_power_mode)


@pytest.mark.parametrize("grid_type", ["charge", "ljr", "lja"])
def test_plain_twin_matches_pallas_interpret(grid_type):
    """The f32 CPU route (the CUDA kernel's plain twin) against the JAX
    package's own CPU route to the Pallas kernel."""
    pos, q, sig, eps = _receptor(53)
    ref = np.asarray(generate_grid_values_pallas(
        COUNTS, SPACING, ORIGIN, grid_type, pos, q, sig, eps, 800.0,
        interpret=True))
    got = gridgen.generate_grid(COUNTS, SPACING, ORIGIN, grid_type, pos,
                                q, sig, eps, grid_cap=800.0,
                                dtype=torch.float32, device="cpu").vals
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cap_saturates_exactly_on_an_atom(dtype):
    got = gridgen.generate_grid(
        (3, 3, 3), (0.1,) * 3, (0.0,) * 3, "ljr", np.array([[0.1] * 3]),
        np.array([0.0]), np.array([0.3]), np.array([1.0]), grid_cap=500.0,
        dtype=dtype, device="cpu").vals
    assert float(got[1, 1, 1]) == 500.0


@pytest.mark.parametrize("grid_type", ["charge", "ljr", "lja"])
@pytest.mark.parametrize("convention", ["rmin", "diameter"])
def test_auto_scaling_factors_match_jax(grid_type, convention):
    _, q, sig, eps = _receptor(3)
    ref = np.asarray(jgridgen.auto_scaling_factors(grid_type, q, sig, eps,
                                                   convention))
    got = gridgen.auto_scaling_factors(grid_type, q, sig, eps, convention)
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_values_at_points_and_positions_match_jax():
    pos, q, sig, eps = _receptor(4)
    idx = np.arange(0, np.prod(COUNTS), 7)
    ref_pts = jgridgen.grid_point_positions(
        COUNTS, jnp.asarray(SPACING), jnp.asarray(ORIGIN), jnp.asarray(idx))
    pts = gridgen.grid_point_positions(
        COUNTS, torch.tensor(SPACING, dtype=torch.float64),
        torch.tensor(ORIGIN, dtype=torch.float64), torch.from_numpy(idx))
    np.testing.assert_allclose(pts.numpy(), np.asarray(ref_pts), rtol=1e-15)
    for gt in ("charge", "ljr", "lja"):
        ref = np.asarray(jgridgen._values_at_points(
            ref_pts, gt, jnp.asarray(pos), jnp.asarray(q), jnp.asarray(sig),
            jnp.asarray(eps), 800.0))
        got = gridgen._values_at_points(
            pts, gt, *(torch.from_numpy(a) for a in (pos, q, sig, eps)),
            800.0)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())


def test_unported_options_raise():
    """Float64 now runs on the card (the kernels' float64
    instantiations); a dtype the kernels have no instantiation for is
    refused, with or without derivatives, in memory or tiled, before
    anything touches the device."""
    pos, q, sig, eps = _receptor(5)
    for dtype in (torch.float16, torch.bfloat16):
        for derivs in (False, True):
            with pytest.raises(ValueError, match="float32 or float64"):
                gridgen.generate_grid(COUNTS, SPACING, ORIGIN, "ljr", pos,
                                      q, sig, eps,
                                      compute_derivatives=derivs,
                                      dtype=dtype, device="cuda:0")
            with pytest.raises(ValueError, match="float32 or float64"):
                gridgen.generate_grid_to_tiled_file(
                    "never-written.tiled", COUNTS, SPACING, ORIGIN, "ljr",
                    pos, q, sig, eps, compute_derivatives=derivs,
                    dtype=dtype, device="cuda:0")
