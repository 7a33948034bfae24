"""Port packing and packed evaluation (openmmgridforce_tpu_torch.ops.packed)
vs the JAX package at float64."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmgridforce_tpu.grid import Grid as JGrid
from openmmgridforce_tpu.ops import packed as jpacked
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.ops import packed
from openmmgridforce_tpu_torch.ops.lanewise import lanewise

torch.set_num_threads(1)

COUNTS = (7, 8, 9)
SPACING = (0.1, 0.12, 0.09)
ORIGIN = (-0.3, 0.1, 0.2)


def _grids(seed, method, mode, positive=False):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(COUNTS) * 50.0
    if positive:
        vals = np.abs(vals) + 1.0
    kw = dict(interp_method=method, inv_power_mode=mode,
              inv_power=3.0 if mode else 0.0, oob_k=500.0)
    jg = JGrid.create(vals, SPACING, ORIGIN, dtype=jnp.float64, **kw)
    tg = convert.grid_from_arrays(vals, SPACING, ORIGIN, device="cpu", **kw)
    return jg, tg


def _positions(seed, lead=()):
    """Atoms inside the box, plus some outside on every side."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(ORIGIN)
    hi = lo + np.asarray(SPACING) * (np.asarray(COUNTS) - 1)
    return rng.uniform(lo - 0.15, hi + 0.15, lead + (23, 3))


@pytest.mark.parametrize("method", [0, 1])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_pack_grid_matches_jax(method, mode):
    jg, tg = _grids(10 + 3 * method + mode, method, mode, positive=True)
    ref = jpacked.pack_grid(jg)
    got = packed.pack_grid(tg)
    assert got.degree == ref.degree and got.back_power == ref.back_power
    r = np.asarray(ref.coeffs)
    np.testing.assert_allclose(got.coeffs.numpy(), r, rtol=1e-12,
                               atol=1e-12 * np.abs(r).max())


def _scaling(seed, n=23):
    s = np.random.default_rng(seed).uniform(-1.0, 1.0, n)
    s[::5] = 0.0                                  # zero scalings included
    return s


@pytest.mark.parametrize("method,mode", [(0, 0), (1, 0), (1, 1), (1, 2)])
def test_evaluate_packed_matches_jax(method, mode):
    jg, tg = _grids(20 + mode, method, mode, positive=mode != 0)
    ref_p = jpacked.pack_grid(jg)
    got_p = packed.pack_grid(tg)
    x = _positions(21, lead=(3,))
    s = _scaling(22)
    got = packed.evaluate_packed(got_p, torch.from_numpy(x), s)
    for r in range(x.shape[0]):
        ref = jpacked.evaluate_packed(ref_p, jnp.asarray(x[r]), s)
        one = packed.evaluate_packed(got_p, torch.from_numpy(x[r]), s)
        for a, b, c in zip(got, ref, one):
            np.testing.assert_allclose(a[r].numpy(), np.asarray(b),
                                       rtol=1e-10, atol=1e-10)
            np.testing.assert_array_equal(a[r].numpy(), c.numpy())


def test_evaluate_multi_matches_jax():
    """Fused charge/ljr/lja-like set with one STORED inv-power grid,
    atoms outside the box and zero scalings; the JAX fused table is
    lane-padded and converted."""
    pairs = [_grids(30, 1, 0), _grids(31, 1, 2, positive=True),
             _grids(32, 1, 0)]
    ref_m = jpacked.combine_packed_grids([jpacked.pack_grid(j)
                                          for j, _ in pairs])
    got_m = packed.combine_packed_grids([packed.pack_grid(t)
                                         for _, t in pairs])
    conv = convert.multi_packed_from_arrays(
        np.asarray(ref_m.coeffs), np.asarray(ref_m.spacing),
        np.asarray(ref_m.origin), counts=ref_m.counts, degree=ref_m.degree,
        n_grids=ref_m.n_grids, back_powers=ref_m.back_powers,
        oob_k=ref_m.oob_k, device="cpu")
    assert got_m.coeffs.shape == (np.prod(np.asarray(COUNTS) - 1), 192)
    np.testing.assert_allclose(got_m.coeffs.numpy(), conv.coeffs.numpy(),
                               rtol=1e-12, atol=1e-12)
    x = _positions(33, lead=(4,))
    s = np.stack([_scaling(34), _scaling(35), _scaling(36)])
    got = packed.evaluate_multi(got_m, torch.from_numpy(x), s)
    for r in range(x.shape[0]):
        ref = jpacked.evaluate_multi(ref_m, jnp.asarray(x[r]), s)
        one = packed.evaluate_multi(conv, torch.from_numpy(x[r]), s)
        for a, b, c in zip(got, ref, one):
            np.testing.assert_allclose(a[r].numpy(), np.asarray(b),
                                       rtol=1e-10, atol=1e-10)
            np.testing.assert_allclose(c.numpy(), a[r].numpy(),
                                       rtol=1e-12, atol=1e-12)


def test_packed_from_arrays_round_trip():
    jg, tg = _grids(40, 1, 0)
    ref = jpacked.pack_grid(jg)
    conv = convert.packed_from_arrays(
        np.asarray(ref.coeffs), np.asarray(ref.spacing),
        np.asarray(ref.origin), counts=ref.counts, degree=ref.degree,
        back_power=ref.back_power, oob_k=ref.oob_k, device="cpu")
    x = torch.from_numpy(_positions(41))
    s = _scaling(42)
    a = packed.evaluate_packed(conv, x, s)
    b = packed.evaluate_packed(packed.pack_grid(tg), x, s)
    np.testing.assert_allclose(a.forces.numpy(), b.forces.numpy(),
                               rtol=1e-12, atol=1e-12)


def test_hermite_methods_raise():
    """A Hermite-method grid without derivatives cannot be packed."""
    _, tg = _grids(50, 2, 0)
    with pytest.raises(ValueError, match="precomputed derivatives"):
        packed.pack_grid(tg)


NCX = COUNTS[0] - 1


def _hermite_grids(seed, method):
    """A tricubic/triquintic grid with random derivatives, both packages."""
    rng = np.random.default_rng(seed)
    derivs = rng.standard_normal(COUNTS + (27,)) * 20.0
    kw = dict(interp_method=method, oob_k=500.0)
    jg = JGrid.create(derivs[..., 0], SPACING, ORIGIN, derivs=derivs,
                      dtype=jnp.float64, **kw)
    tg = convert.grid_from_arrays(derivs[..., 0], SPACING, ORIGIN,
                                  derivs=derivs, device="cpu", **kw)
    return jg, tg


@pytest.mark.parametrize("x_chunk", [1, 3, NCX])
@pytest.mark.parametrize("method,mode", [(0, 0), (1, 0), (1, 1), (3, 0)],
                         ids=["trilinear", "bspline", "bspline-runtime",
                              "triquintic"])
def test_pack_grids_fused_matches_jax(method, mode, x_chunk):
    """Slab by slab into one table: equal to JAX's fused table with its
    lane padding dropped, and to the port's combine_packed_grids of whole
    packs."""
    if method == 3:
        pairs = [_hermite_grids(60 + g, method) for g in range(3)]
    else:
        pairs = [_grids(60 + g, method, mode if g == 1 else 0,
                        positive=True) for g in range(3)]
    ref = jpacked.pack_grids_fused([j for j, _ in pairs], x_chunk=x_chunk)
    got = packed.pack_grids_fused([t for _, t in pairs], x_chunk=x_chunk,
                                  device="cpu")
    whole = packed.combine_packed_grids([packed.pack_grid(t)
                                         for _, t in pairs])
    width = got.coeffs.shape[1]
    assert width == 3 * ref.degree ** 3 == whole.coeffs.shape[1]
    r = np.asarray(ref.coeffs)[:, :width]
    np.testing.assert_allclose(got.coeffs.numpy(), r, rtol=1e-12,
                               atol=1e-12 * np.abs(r).max())
    np.testing.assert_allclose(got.coeffs.numpy(), whole.coeffs.numpy(),
                               rtol=1e-12,
                               atol=1e-12 * np.abs(r).max())
    for f in ("counts", "degree", "n_grids", "back_powers", "oob_k",
              "poly_basis"):
        assert getattr(got, f) == getattr(ref, f) == getattr(whole, f), f


@pytest.mark.parametrize("method,mode", [(1, 2), (3, 0)],
                         ids=["bspline-stored", "triquintic"])
def test_pack_grid_slabs_match_whole(method, mode):
    """pack_grid(x_chunk=) equals the whole-grid pack and JAX's slab
    pack."""
    if method == 3:
        jg, tg = _hermite_grids(70, method)
    else:
        jg, tg = _grids(70, method, mode, positive=True)
    whole = packed.pack_grid(tg)
    for x_chunk in (1, 4):
        got = packed.pack_grid(tg, x_chunk=x_chunk)
        ref = jpacked.pack_grid(jg, x_chunk=x_chunk)
        scale = float(whole.coeffs.abs().max())
        np.testing.assert_allclose(got.coeffs.numpy(),
                                   whole.coeffs.numpy(), rtol=1e-12,
                                   atol=1e-12 * scale)
        np.testing.assert_allclose(got.coeffs.numpy(),
                                   np.asarray(ref.coeffs), rtol=1e-12,
                                   atol=1e-12 * scale)


def test_pack_grids_fused_refuses_mixed_grids():
    a = _grids(80, 1, 0)[1]
    b = _grids(81, 0, 0)[1]
    with pytest.raises(ValueError, match="share"):
        packed.pack_grids_fused([a, b], device="cpu")


def test_grid_members_match_jax():
    """Grid.has_derivatives, num_points and with_ (openmmgridforce_tpu/
    grid.py:132-143) on the port's Grid."""
    for derivs in (False, True):
        jg, tg = (_hermite_grids(41, 3) if derivs else _grids(41, 1, 0))
        assert tg.has_derivatives == jg.has_derivatives == derivs
        assert tg.num_points == jg.num_points == int(np.prod(COUNTS))
        jn, tn = jg.with_(oob_k=12.5), tg.with_(oob_k=12.5)
        assert tn.oob_k == jn.oob_k == 12.5 and tg.oob_k == jg.oob_k
        assert tn.vals is tg.vals and tn.counts == jn.counts


def test_pack_members_match_jax():
    """cell_counts on the four pack classes and num_grids on the two fused
    ones, as the JAX package's packs give them."""
    jg, tg = _grids(42, 1, 0)
    jh, th = _hermite_grids(43, 3)
    pairs = [(jpacked.pack_grid(jg), packed.pack_grid(tg)),
             (jpacked.combine_packed_grids([jpacked.pack_grid(jg)] * 3),
              packed.combine_packed_grids([packed.pack_grid(tg)] * 3)),
             (jpacked.pack_grid_hermite(jh), packed.pack_grid_hermite(th)),
             (jpacked.combine_hermite_packed(
                 [jpacked.pack_grid_hermite(jh)] * 2),
              packed.combine_hermite_packed(
                  [packed.pack_grid_hermite(th)] * 2))]
    for ref, got in pairs:
        assert got.cell_counts == tuple(ref.cell_counts) == tuple(
            c - 1 for c in COUNTS)
    for ref, got in (pairs[1], pairs[3]):
        assert got.num_grids == ref.num_grids == ref.n_grids


# packs a B-spline grid and a triquintic grid (monomial, Chebyshev) at 1
# and at 4 threads in one process; prints whether each pair is equal
_THREADS_SCRIPT = """
import numpy as np, torch
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.ops import packed
rng = np.random.default_rng(3)
counts = (40, 42, 44)
vals = rng.standard_normal(counts) * 50.0
derivs = rng.standard_normal(counts + (27,)) * 50.0
grids = [convert.grid_from_arrays(vals, (0.1,) * 3, (0.0,) * 3,
                                  interp_method=m, derivs=d, device="cpu")
         for m, d in ((1, None), (3, derivs))]
out = []
for g in grids:
    for basis in ("monomial", "chebyshev"):
        packs = []
        for n in (1, 4):
            torch.set_num_threads(n)
            packs.append(packed.pack_grid(g, poly_basis=basis).coeffs)
        out.append(torch.equal(*packs))
print(out)
"""


def test_host_packing_does_not_depend_on_the_thread_count():
    """A pack made on the host is the same bit for bit at 1 and at 4
    threads, with MKL held to its AVX2 code (a CPU without AVX-512),
    whose products of the packing contractions' shape sum in another
    order with more threads: a rank of a mesh, which runs with its share
    of the cores, packs what one process packs."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "MKL_ENABLE_INSTRUCTIONS": "AVX2",
           "PYTHONPATH": str(root)}
    out = subprocess.run([sys.executable, "-c", _THREADS_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert out.strip().splitlines()[-1] == "[True, True, True, True]"


def test_host_contraction_matches_einsum():
    """The host's fixed-order axis contraction against torch.einsum, with
    two contracted axes brought to the front."""
    rng = np.random.default_rng(5)
    H = torch.from_numpy(rng.standard_normal((6, 3, 2)))
    S = torch.from_numpy(rng.standard_normal((2, 5, 4, 3, 2)))
    want = torch.einsum("pms,sijmo->pijo", H, S)
    got = packed._host_contract(H, S, 2, (3, 0, 1, 2, 4))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13,
                               atol=1e-13)


@pytest.mark.parametrize("fn", [torch.atan2, torch.pow])
def test_lanewise_rounds_every_element_alike(fn):
    """An element's value from ``lanewise`` is the same whatever the length
    of the array and its place in it (ATen's vectorised loop and scalar
    tail round some arguments differently)."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.uniform(0.1, 3.0, 1000))
    b = torch.from_numpy(rng.uniform(-2.0, 2.0, 1000))
    whole = lanewise(fn, a, b)
    for lo, hi in ((0, 1), (3, 50), (17, 1000), (990, 1000), (0, 999)):
        assert torch.equal(lanewise(fn, a[lo:hi], b[lo:hi]), whole[lo:hi])
    grid = lanewise(fn, a.reshape(40, 25), b[:25])
    assert torch.equal(grid[7], lanewise(fn, a[175:200], b[:25]))
    if fn is torch.pow:
        # a number as the exponent, as a grid's back power is passed
        assert torch.equal(lanewise(fn, a[3:50], 1.7),
                           lanewise(fn, a, 1.7)[3:50])
    np.testing.assert_allclose(whole.numpy(), fn(a, b).numpy(), rtol=1e-15)
