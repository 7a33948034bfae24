"""The port's derivative path (radial tables, Faa di Bruno chain rules, the
plain twin of the CUDA derivative kernel, generate_grid with 27
derivatives) vs the JAX package. Float64 on the CPU unless stated; the
float32 twin is held against the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmgridforce_tpu.grid import InvPowerMode as JInvPowerMode
from openmmgridforce_tpu.ops import chain_rules as jchain
from openmmgridforce_tpu.ops import gridgen as jgridgen
from openmmgridforce_tpu.ops import radial as jradial
from openmmgridforce_tpu.ops.pallas_gridgen_derivs import (
    generate_raw_derivs_pallas)
from openmmgridforce_tpu_torch.grid import InvPowerMode
from openmmgridforce_tpu_torch.ops import (chain_rules, cuda_gridgen_derivs,
                                           derivatives27, gridgen, radial)

torch.set_num_threads(1)

COUNTS = (6, 7, 8)
SPACING = (0.1, 0.11, 0.09)
ORIGIN = (0.0, -0.2, 0.3)
GRID_TYPES = ("charge", "ljr", "lja")


def _receptor(seed, n=11):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.3, 1.2, (n, 3)), rng.uniform(-1, 1, n),
            rng.uniform(0.2, 0.35, n), rng.uniform(0.1, 1.0, n))


def _slot_err(got, ref):
    """max |got - ref| per derivative slot over the slot's max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    axes = tuple(range(ref.ndim - 1))
    return (np.abs(got - ref).max(axis=axes)
            / (np.abs(ref).max(axis=axes) + 1e-30)).max()


def test_derivative_layout_matches_jax():
    from openmmgridforce_tpu.ops import derivatives27 as jd27
    assert derivatives27.DERIV_ORDERS == jd27.DERIV_ORDERS
    assert derivatives27.TRICUBIC_DERIV_MAP == jd27.TRICUBIC_DERIV_MAP
    np.testing.assert_array_equal(
        derivatives27.spacing_scale_factors(SPACING),
        jd27.spacing_scale_factors(SPACING))
    assert chain_rules.faa_di_bruno_tables() == jchain.faa_di_bruno_tables()


@pytest.mark.parametrize("grid_type,lj_convention", [
    ("charge", "rmin"), ("ljr", "rmin"), ("lja", "rmin"),
    ("ljr", "diameter"), ("lja", "diameter")])
def test_radial_tables_match_jax(grid_type, lj_convention):
    """radial_derivatives and radial_to_cartesian, with and without the
    atom-axis reduction; 1e-12 relative (the same float64 arithmetic)."""
    rng = np.random.default_rng(7)
    dr = rng.uniform(-0.6, 0.6, (5, 9, 3))
    r2 = np.maximum((dr * dr).sum(-1), 4e-4)
    q, sig, eps = (rng.uniform(-1, 1, 9), rng.uniform(0.2, 0.35, 9),
                   rng.uniform(0.1, 1.0, 9))
    ref_rad = jradial.radial_derivatives(jnp.asarray(r2), grid_type, q, sig,
                                         eps, lj_convention)
    rad = radial.radial_derivatives(
        torch.from_numpy(r2), grid_type,
        *(torch.from_numpy(a) for a in (q, sig, eps)), lj_convention)
    np.testing.assert_allclose(rad.numpy(), np.asarray(ref_rad), rtol=1e-12)
    for axis in (None, -1):
        ref = jradial.radial_to_cartesian(jnp.asarray(dr), ref_rad,
                                          reduce_axis=axis)
        got = radial.radial_to_cartesian(torch.from_numpy(dr), rad,
                                         reduce_axis=axis)
        assert got.shape == ref.shape
        assert _slot_err(got.numpy(), ref) < 1e-12


def _raw_field(seed, n, dtype=np.float64):
    """[n, 27] raw derivative sums whose value spans both sides of the
    0.1 cap passthrough, negative values and saturation (u > 20)."""
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n, 27)) * 40.0
    U[:, 0] = np.concatenate([
        rng.uniform(-300.0, 9.0, n // 3),          # u < 0.1: passthrough
        rng.uniform(11.0, 900.0, n // 3),          # capped
        rng.uniform(2500.0, 1e6, n - 2 * (n // 3))])  # u > 20: saturated
    return U.astype(dtype)


@pytest.mark.parametrize("passthrough", [True, False])
def test_apply_tanh_cap_matches_jax(passthrough):
    U = _raw_field(11, 60)
    ref = np.asarray(jchain.apply_tanh_cap(jnp.asarray(U), 100.0,
                                           passthrough))
    got = chain_rules.apply_tanh_cap(torch.from_numpy(U), 100.0,
                                     passthrough).numpy()
    # 1e-9 of the slot's max: both take tanh from their own libm, and
    # 1 - tanh^2 amplifies its last ulp near saturation
    assert _slot_err(got, ref) < 1e-9
    low = U[:, 0] / 100.0 < 0.1
    if passthrough:
        np.testing.assert_array_equal(got[low], U[low])
    sat = U[:, 0] / 100.0 > 20.0
    assert (got[sat, 0] == 100.0).all() and (got[sat, 1:] == 0.0).all()


def test_saturated_cap_of_huge_slots_is_finite():
    """float32, slots of 1e35 under a saturated cap: every term starts
    from g^(k) = 0 and stays 0; a product of slots formed first would be
    inf, and inf * 0 is nan."""
    U = np.full((4, 27), 1e35, np.float32)
    U[:, 0] = [1e6, 1e17, 3e30, 1e35]
    got = chain_rules.apply_tanh_cap(torch.from_numpy(U), 41840.0).numpy()
    ref = np.asarray(jchain.apply_tanh_cap(jnp.asarray(U), 41840.0))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)
    assert (got[:, 0] == np.float32(41840.0)).all()
    assert (got[:, 1:] == 0.0).all()


@pytest.mark.parametrize("p", [0.25, 1.0 / 3.0])
def test_apply_invpower_matches_jax(p):
    U = _raw_field(13, 45)
    U[:3, 0] = [0.0, 5e-11, -5e-11]               # inside the 1e-10 clamp
    ref = np.asarray(jchain.apply_invpower(jnp.asarray(U), p))
    got = chain_rules.apply_invpower(torch.from_numpy(U), p).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-11,
                               atol=1e-11 * np.abs(ref).max())
    jv, jd = jchain.invpower_g_derivatives(jnp.asarray(U[:, 0]), p)
    tv, td = chain_rules.invpower_g_derivatives(torch.from_numpy(U[:, 0]), p)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def _atoms32(grid_type, pos, q, sig, eps):
    return gridgen.receptor_atoms(grid_type, pos.astype(np.float32), q, sig,
                                  eps, device="cpu")


@pytest.mark.parametrize("grid_type", GRID_TYPES)
def test_plain_twin_matches_pallas_interpret(grid_type):
    """The float32 plain twin of the CUDA kernel against the Pallas kernel
    as the JAX package runs it on the CPU: 5e-5 of each slot's max, the
    JAX package's own Pallas-against-jnp float32 gate."""
    pos, q, sig, eps = _receptor(53)
    ref = np.asarray(generate_raw_derivs_pallas(
        COUNTS, SPACING, ORIGIN, grid_type, pos.astype(np.float32), q, sig,
        eps, interpret=True))
    got = cuda_gridgen_derivs.gridgen_derivs(
        _atoms32(grid_type, pos, q, sig, eps), COUNTS, SPACING, ORIGIN,
        grid_type)
    assert got.dtype == torch.float32 and got.shape == COUNTS + (27,)
    assert cuda_gridgen_derivs.gridgen_derivs.launches == 0
    assert _slot_err(got.numpy(), ref) < 5e-5


@pytest.mark.parametrize("grid_type", GRID_TYPES)
def test_plain_twin_tracks_f64_ground_truth(grid_type):
    """The float32 twin against the float64 field laws (the ground truth of
    the JAX package's Pallas test): 2e-4 of each slot's max."""
    pos, q, sig, eps = _receptor(54)
    pos = pos.astype(np.float32)
    idx = jnp.arange(np.prod(COUNTS))
    pts = jgridgen.grid_point_positions(
        COUNTS, jnp.asarray(SPACING, jnp.float64),
        jnp.asarray(ORIGIN, jnp.float64), idx)
    dr = pts[:, None, :] - jnp.asarray(pos, jnp.float64)
    r2 = jnp.maximum(jnp.sum(dr * dr, -1), 4e-4)
    rad = jradial.radial_derivatives(r2, grid_type, jnp.asarray(q),
                                     jnp.asarray(sig), jnp.asarray(eps))
    want = np.asarray(jnp.sum(jradial.radial_to_cartesian(dr, rad), axis=1))
    atoms = _atoms32(grid_type, pos, q, sig, eps)
    got = cuda_gridgen_derivs.gridgen_derivs_plain(atoms, COUNTS, SPACING,
                                                   ORIGIN, grid_type)
    assert _slot_err(got.numpy(), want) < 2e-4
    # the twin in float64 is the chip check's second reference
    got64 = cuda_gridgen_derivs.gridgen_derivs_plain(
        atoms.double(), COUNTS, SPACING, ORIGIN, grid_type)
    assert _slot_err(got64.numpy(), want) < 1e-6


def test_plain_twin_ranges_and_chunks_agree():
    pos, q, sig, eps = _receptor(55, n=13)
    atoms = _atoms32("lja", pos, q, sig, eps).double()
    args = (atoms, COUNTS, SPACING, ORIGIN, "lja")
    whole = cuda_gridgen_derivs.gridgen_derivs_plain(*args)
    part = cuda_gridgen_derivs.gridgen_derivs_plain(*args, start=50,
                                                    stop=211, pair_block=29)
    np.testing.assert_allclose(part.numpy(), whole[50:211].numpy(),
                               rtol=1e-13, atol=0)
    with pytest.raises(ValueError, match="range"):
        cuda_gridgen_derivs.gridgen_derivs_plain(*args, start=5, stop=4)
    with pytest.raises(ValueError, match=r"\[A, 4\]"):
        cuda_gridgen_derivs.gridgen_derivs(atoms[:, :3], *args[1:])


@pytest.mark.parametrize("grid_type,mode,lj_convention", [
    ("charge", "NONE", "rmin"), ("ljr", "NONE", "rmin"),
    ("lja", "NONE", "rmin"), ("charge", "STORED", "rmin"),
    ("ljr", "STORED", "rmin"), ("lja", "STORED", "rmin"),
    ("ljr", "RUNTIME", "rmin"), ("ljr", "NONE", "diameter")])
def test_generate_grid_with_derivatives_matches_jax(grid_type, mode,
                                                    lj_convention):
    """1e-6 of each slot's max: float64 on both sides, but the capped
    points between the passthrough and saturation multiply 1 - tanh^2,
    taken from two libms, by products of large raw derivatives."""
    pos, q, sig, eps = _receptor(3)
    inv_power = 0.0 if mode == "NONE" else 4.0
    kw = dict(compute_derivatives=True, grid_cap=800.0, inv_power=inv_power,
              lj_convention=lj_convention)
    ref = jgridgen.generate_grid(
        COUNTS, SPACING, ORIGIN, grid_type, pos, q, sig, eps,
        inv_power_mode=JInvPowerMode[mode], backend="jnp",
        dtype=jnp.float64, **kw)
    got = gridgen.generate_grid(
        COUNTS, SPACING, ORIGIN, grid_type, pos, q, sig, eps,
        inv_power_mode=InvPowerMode[mode], dtype=torch.float64,
        device="cpu", **kw)
    assert got.derivs.shape == COUNTS + (27,)
    assert _slot_err(got.derivs.numpy(), ref.derivs) < 1e-6
    assert torch.equal(got.vals, got.derivs[..., 0])
    assert (got.inv_power, got.inv_power_mode) == (ref.inv_power,
                                                   ref.inv_power_mode)
    u = np.asarray(ref.derivs)[..., 0]
    if (mode, grid_type, lj_convention) == ("NONE", "ljr", "rmin"):
        # the grid has points on both sides of the passthrough
        assert (u < 80.0).any() and (u > 700.0).any()


def test_generate_grid_with_derivatives_float32_cpu():
    """float32 on the CPU against the JAX package's float32 jnp path, at
    its own float32 gate (5e-5 per slot)."""
    pos, q, sig, eps = _receptor(4)
    args = (COUNTS, SPACING, ORIGIN, "lja", pos, q, sig, eps)
    ref = jgridgen.generate_grid(*args, compute_derivatives=True,
                                 backend="jnp", dtype=jnp.float32)
    got = gridgen.generate_grid(*args, compute_derivatives=True,
                                device="cpu")
    assert got.derivs.dtype == torch.float32
    assert _slot_err(got.derivs.numpy(), ref.derivs) < 5e-5


def test_postprocess_chunks_agree_and_match_jax():
    U = _raw_field(17, 50).reshape(5, 10, 27)
    kw = dict(grid_cap=100.0, inv_power=3.0,
              inv_power_mode=InvPowerMode.STORED, spacing=SPACING)
    whole = gridgen._postprocess_raw_derivs(torch.from_numpy(U), **kw)
    parts = gridgen._postprocess_raw_derivs(torch.from_numpy(U),
                                            point_chunk=7, **kw)
    # the CPU's vectorised pow and tanh round a lane and a tail apart
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-13)
    assert whole.shape == U.shape
    ref = jgridgen._postprocess_raw_derivs(
        jnp.asarray(U), grid_cap=100.0, inv_power=3.0,
        inv_power_mode=JInvPowerMode.STORED, spacing=SPACING)
    assert _slot_err(whole.numpy(), ref) < 1e-9
