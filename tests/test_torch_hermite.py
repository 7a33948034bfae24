"""Port Hermite-method packs (openmmgridforce_tpu_torch.ops.packed: monomial
and Chebyshev per-cell polynomials, Hermite corner rows, both fused forms)
vs the JAX package and vs the port's reference-layout evaluate_grid, at
float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmgridforce_tpu.grid import Grid as JGrid
from openmmgridforce_tpu.ops import packed as jpacked
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.mm import system
from openmmgridforce_tpu_torch.ops import interpolate, packed

torch.set_num_threads(1)

COUNTS = (6, 7, 8)
SPACING = (0.1, 0.12, 0.09)
ORIGIN = (-0.3, 0.1, 0.2)
N_ATOMS = 19


def _grids(seed, method, mode, dtype=np.float64):
    rng = np.random.default_rng(seed)
    derivs = rng.standard_normal(COUNTS + (27,)) * 20.0
    derivs[..., 0] *= 2.5
    if mode:
        derivs[..., 0] = np.abs(derivs[..., 0]) + 1.0
    kw = dict(interp_method=method, inv_power_mode=mode,
              inv_power=3.0 if mode else 0.0, oob_k=500.0)
    jg = JGrid.create(derivs[..., 0], SPACING, ORIGIN, derivs=derivs,
                      dtype=jnp.dtype(dtype), **kw)
    tg = convert.grid_from_arrays(
        derivs[..., 0], SPACING, ORIGIN, derivs=derivs, device="cpu",
        dtype=torch.from_numpy(np.zeros(1, dtype)).dtype, **kw)
    return jg, tg


def _positions(seed, lead=()):
    rng = np.random.default_rng(seed)
    lo = np.asarray(ORIGIN)
    hi = lo + np.asarray(SPACING) * (np.asarray(COUNTS) - 1)
    return rng.uniform(lo - 0.15, hi + 0.15, lead + (N_ATOMS, 3))


def _scaling(seed):
    s = np.random.default_rng(seed).uniform(-1.0, 1.0, N_ATOMS)
    s[::5] = 0.0
    return s


def _assert_evals_close(got, ref, tol):
    for a, b in zip(got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=tol,
                                   atol=tol * max(1.0, np.abs(b).max()))


CASES = [(2, "monomial", 0), (2, "chebyshev", 0), (3, "monomial", 0),
         (3, "chebyshev", 0), (3, "chebyshev", 1), (3, "chebyshev", 2),
         (2, "monomial", 1), (1, "chebyshev", 0)]


@pytest.mark.parametrize("method,poly_basis,mode", CASES)
def test_pack_grid_matches_jax_and_evaluate_grid(method, poly_basis, mode):
    """Tricubic and triquintic packs in both bases (and a B-spline pack in
    the Chebyshev basis): the table against the JAX one at 1e-10 of its
    max, the evaluation against the JAX evaluation and against the port's
    evaluate_grid at 1e-9 (the monomial form cancels a few digits)."""
    jg, tg = _grids(100 + 7 * method + mode, method, mode)
    ref_p = jpacked.pack_grid(jg, poly_basis=poly_basis)
    got_p = packed.pack_grid(tg, poly_basis=poly_basis)
    assert (got_p.degree, got_p.back_power, got_p.poly_basis) == (
        ref_p.degree, ref_p.back_power, ref_p.poly_basis)
    r = np.asarray(ref_p.coeffs)
    np.testing.assert_allclose(got_p.coeffs.numpy(), r, rtol=1e-10,
                               atol=1e-10 * np.abs(r).max())
    x = _positions(101, lead=(2,))
    s = _scaling(102)
    got = packed.evaluate_packed(got_p, torch.from_numpy(x), s)
    direct = interpolate.evaluate_grid(tg, torch.from_numpy(x), s)
    _assert_evals_close(got, direct, 1e-9)
    for row in range(2):
        ref = jpacked.evaluate_packed(ref_p, jnp.asarray(x[row]), s)
        _assert_evals_close([t[row] for t in got], ref, 1e-9)
    conv = convert.packed_from_arrays(
        r, np.asarray(ref_p.spacing), np.asarray(ref_p.origin),
        counts=ref_p.counts, degree=ref_p.degree,
        back_power=ref_p.back_power, oob_k=ref_p.oob_k,
        poly_basis=ref_p.poly_basis, device="cpu")
    _assert_evals_close(packed.evaluate_packed(conv, torch.from_numpy(x), s),
                        got, 1e-9)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_default_basis_follows_jax(dtype):
    """Chebyshev for float32 Hermite-method packs, monomial otherwise; the
    float32 Chebyshev pack contracts in float32 on both sides (1e-5)."""
    jg, tg = _grids(110, 3, 0, dtype)
    ref_p, got_p = jpacked.pack_grid(jg), packed.pack_grid(tg)
    want = "chebyshev" if dtype == np.float32 else "monomial"
    assert got_p.poly_basis == ref_p.poly_basis == want
    assert got_p.coeffs.dtype == tg.vals.dtype
    r = np.asarray(ref_p.coeffs)
    tol = 1e-5 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(got_p.coeffs.numpy(), r, rtol=0,
                               atol=tol * np.abs(r).max())
    jv, tv = _grids(111, 1, 0, dtype)
    assert packed.pack_grid(tv).poly_basis == "monomial"
    with pytest.raises(ValueError, match="poly_basis"):
        packed.pack_grid(tg, poly_basis="legendre")


@pytest.mark.parametrize("method", [2, 3])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_pack_grid_hermite_matches_jax_and_evaluate_grid(method, mode):
    jg, tg = _grids(120 + 3 * method + mode, method, mode)
    ref_p = jpacked.pack_grid_hermite(jg)
    got_p = packed.pack_grid_hermite(tg)
    assert got_p.coeffs.shape == (np.prod(np.asarray(COUNTS) - 1),
                                  8 * (8 if method == 2 else 27))
    assert (got_p.method, got_p.back_power) == (ref_p.method,
                                                ref_p.back_power)
    np.testing.assert_allclose(got_p.coeffs.numpy(),
                               np.asarray(ref_p.coeffs), rtol=1e-11)
    x = _positions(121, lead=(2,))
    s = _scaling(122)
    got = packed.evaluate_hermite_packed(got_p, torch.from_numpy(x), s)
    _assert_evals_close(
        got, interpolate.evaluate_grid(tg, torch.from_numpy(x), s), 1e-11)
    for row in range(2):
        ref = jpacked.evaluate_hermite_packed(ref_p, jnp.asarray(x[row]), s)
        _assert_evals_close([t[row] for t in got], ref, 1e-10)
    conv = convert.hermite_packed_from_arrays(
        np.asarray(ref_p.coeffs), np.asarray(ref_p.spacing),
        np.asarray(ref_p.origin), counts=ref_p.counts, method=ref_p.method,
        back_power=ref_p.back_power, oob_k=ref_p.oob_k, device="cpu")
    _assert_evals_close(
        packed.evaluate_hermite_packed(conv, torch.from_numpy(x), s), got,
        1e-11)


def _fused_set(method):
    """Three co-located grids, the middle one with a STORED inverse power."""
    return [_grids(130, method, 0), _grids(131, method, 2),
            _grids(132, method, 0)]


@pytest.mark.parametrize("method,poly_basis", [(3, "chebyshev"),
                                               (2, "monomial")])
def test_fused_polynomial_packs_match_jax(method, poly_basis):
    pairs = _fused_set(method)
    ref_m = jpacked.combine_packed_grids(
        [jpacked.pack_grid(j, poly_basis=poly_basis) for j, _ in pairs])
    got_m = packed.combine_packed_grids(
        [packed.pack_grid(t, poly_basis=poly_basis) for _, t in pairs])
    K = 64 if method == 2 else 216
    assert got_m.coeffs.shape[1] == 3 * K and got_m.poly_basis == poly_basis
    assert ref_m.coeffs.shape[1] % 128 == 0        # the JAX table is padded
    conv = convert.multi_packed_from_arrays(
        np.asarray(ref_m.coeffs), np.asarray(ref_m.spacing),
        np.asarray(ref_m.origin), counts=ref_m.counts, degree=ref_m.degree,
        n_grids=ref_m.n_grids, back_powers=ref_m.back_powers,
        oob_k=ref_m.oob_k, poly_basis=ref_m.poly_basis, device="cpu")
    c = conv.coeffs.numpy()
    np.testing.assert_allclose(got_m.coeffs.numpy(), c, rtol=1e-10,
                               atol=1e-10 * np.abs(c).max())
    x = _positions(133, lead=(3,))
    s = np.stack([_scaling(134), _scaling(135), _scaling(136)])
    got = packed.evaluate_multi(got_m, torch.from_numpy(x), s)
    _assert_evals_close(packed.evaluate_multi(conv, torch.from_numpy(x), s),
                        got, 1e-9)
    for row in range(3):
        ref = jpacked.evaluate_multi(ref_m, jnp.asarray(x[row]), s)
        _assert_evals_close([t[row] for t in got], ref, 1e-9)
    # through the System's dispatch, against the sum of single evaluations
    gb = system.GridBinding(grid=got_m, scaling=torch.from_numpy(s))
    e = system.grid_energy([gb], torch.from_numpy(x))
    np.testing.assert_allclose(e.numpy(), got.energy.numpy(), rtol=1e-14)


@pytest.mark.parametrize("method", [2, 3])
def test_fused_hermite_packs_match_jax(method):
    pairs = _fused_set(method)
    ref_m = jpacked.combine_hermite_packed(
        [jpacked.pack_grid_hermite(j) for j, _ in pairs])
    singles = [packed.pack_grid_hermite(t) for _, t in pairs]
    got_m = packed.combine_hermite_packed(singles)
    D = 8 if method == 2 else 27
    assert got_m.coeffs.shape[1] == 3 * 8 * D
    conv = convert.multi_hermite_packed_from_arrays(
        np.asarray(ref_m.coeffs), np.asarray(ref_m.spacing),
        np.asarray(ref_m.origin), counts=ref_m.counts, method=ref_m.method,
        n_grids=ref_m.n_grids, back_powers=ref_m.back_powers,
        oob_k=ref_m.oob_k, device="cpu")
    np.testing.assert_allclose(got_m.coeffs.numpy(), conv.coeffs.numpy(),
                               rtol=1e-11)
    x = _positions(137, lead=(3,))
    s = np.stack([_scaling(138), _scaling(139), _scaling(140)])
    got = packed.evaluate_hermite_multi(got_m, torch.from_numpy(x), s)
    for row in range(3):
        ref = jpacked.evaluate_hermite_multi(ref_m, jnp.asarray(x[row]), s)
        _assert_evals_close([t[row] for t in got], ref, 1e-10)
    # inside the box the fused forces are the sum of the single packs'
    xin = torch.from_numpy(np.clip(
        x, np.asarray(ORIGIN) + 1e-3,
        np.asarray(ORIGIN) + np.asarray(SPACING) * (np.asarray(COUNTS) - 1)
        - 1e-3))
    total = sum(packed.evaluate_hermite_packed(p, xin, s[g]).forces
                for g, p in enumerate(singles))
    gb = system.GridBinding(grid=got_m, scaling=torch.from_numpy(s))
    np.testing.assert_allclose(
        system._eval_grid(gb.grid, xin, gb.scaling).forces.numpy(),
        total.numpy(), rtol=1e-10, atol=1e-9)


def test_fusion_refuses_mixed_sets():
    _, a = _grids(150, 3, 0)
    _, b = _grids(151, 3, 0)
    _, c = _grids(152, 2, 0)
    with pytest.raises(ValueError, match="poly_basis"):
        packed.combine_packed_grids(
            [packed.pack_grid(a, poly_basis="monomial"),
             packed.pack_grid(b, poly_basis="chebyshev")])
    with pytest.raises(ValueError, match="method"):
        packed.combine_hermite_packed([packed.pack_grid_hermite(a),
                                       packed.pack_grid_hermite(c)])
    with pytest.raises(ValueError, match="tricubic/triquintic"):
        packed.pack_grid_hermite(_grids(153, 1, 0)[1])
    bare = convert.grid_from_arrays(a.vals.numpy(), SPACING, ORIGIN,
                                    interp_method=3, device="cpu")
    for pack in (packed.pack_grid, packed.pack_grid_hermite):
        with pytest.raises(ValueError, match="precomputed derivatives"):
            pack(bare)


@pytest.mark.parametrize("form", ["chebyshev", "monomial", "hermite",
                                  "multi_chebyshev", "multi_hermite"])
def test_forces_are_minus_the_energy_gradient(form):
    pairs = _fused_set(3)
    x = torch.from_numpy(_positions(160, lead=(2,))).requires_grad_(True)
    if form.startswith("multi"):
        s = np.stack([_scaling(161), _scaling(162), _scaling(163)])
        if form == "multi_hermite":
            grid = packed.combine_hermite_packed(
                [packed.pack_grid_hermite(t) for _, t in pairs])
        else:
            grid = packed.combine_packed_grids(
                [packed.pack_grid(t, poly_basis="chebyshev")
                 for _, t in pairs])
    else:
        s = _scaling(161)
        tg = pairs[1][1]
        grid = (packed.pack_grid_hermite(tg) if form == "hermite"
                else packed.pack_grid(tg, poly_basis=form))
    res = system._eval_grid(grid, x, torch.from_numpy(s))
    (grad,) = torch.autograd.grad(res.energy.sum(), x)
    f = res.forces.detach().numpy()
    np.testing.assert_allclose(f, -grad.numpy(), rtol=1e-8,
                               atol=1e-9 * np.abs(f).max())
