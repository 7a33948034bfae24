"""Port out-of-core evaluation (openmmgridforce_tpu_torch.io.streaming) vs
the JAX package on the same OMGTILE files, on the CPU in float64.

The files hold float32 values; both packages' regions are built in float64
here (the JAX evaluator's ``Grid.create`` is handed ``dtype=float64``), on
a grid whose spacing and origin are exact in binary, so that the two
evaluate the same float64 function and agree to 1e-10 of the largest
energy and force. Region hits and misses are counted alike."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from openmmgridforce_tpu.grid import Grid as JGrid
from openmmgridforce_tpu.grid import InterpolationMethod as JMethod
from openmmgridforce_tpu.io import streaming as jstreaming
from openmmgridforce_tpu.ops import gridgen as jgridgen
from openmmgridforce_tpu.ops.packed import pack_grid as jpack_grid
from openmmgridforce_tpu_torch.grid import InterpolationMethod
from openmmgridforce_tpu_torch.io import streaming, write_grid_tiled
from openmmgridforce_tpu_torch.ops import gridgen
from openmmgridforce_tpu_torch.ops.packed import pack_grid

from test_torch_io import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

COUNTS = (24, 22, 20)
SPACING = (0.125,) * 3
ORIGIN = (-1.0, -0.75, -0.5)
REGION = (12, 12, 12)
TOL = 1e-10


class _JGridF64:
    """The JAX Grid with its regions built in float64."""

    @staticmethod
    def create(*args, **kw):
        kw["dtype"] = np.float64
        return JGrid.create(*args, **kw)


@pytest.fixture(autouse=True)
def jax_regions_in_f64(monkeypatch):
    monkeypatch.setattr(jstreaming, "Grid", _JGridF64)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A value file and a 27-derivative file of one receptor field."""
    d = tmp_path_factory.mktemp("stream")
    rng = np.random.default_rng(4)
    rec = rng.uniform(-1.5, 2.5, (30, 3))
    q = rng.uniform(-0.3, 0.3, 30)
    out = {}
    for name, derivs in (("values", False), ("derivs", True)):
        g = gridgen.generate_grid(COUNTS, SPACING, ORIGIN, "charge", rec, q,
                                  np.full(30, 0.3), np.full(30, 0.5),
                                  compute_derivatives=derivs,
                                  grid_cap=400.0, dtype=torch.float64,
                                  device="cpu")
        out[name] = str(d / f"{name}.tiled")
        write_grid_tiled(out[name], g, tile_size=8)
    return out


def _pair(path, method, **kw):
    t = streaming.StreamedGridEvaluator(path, method, region_shape=REGION,
                                        dtype=torch.float64, device="cpu",
                                        **kw)
    j = jstreaming.StreamedGridEvaluator(path, JMethod(int(method)),
                                         region_shape=REGION, **kw)
    return t, j


def _cloud(rng, center, n=9, spread=0.2):
    return np.asarray(center) + rng.uniform(-spread, spread, (n, 3))


def _close(got, ref):
    """GridEval fields of the two packages within TOL of the largest."""
    for a, b in zip(got, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        scale = max(np.abs(b).max(), 1e-300)
        assert np.abs(a - b).max() <= TOL * scale


METHODS = [("values", InterpolationMethod.TRILINEAR),
           ("values", InterpolationMethod.BSPLINE),
           ("derivs", InterpolationMethod.TRICUBIC),
           ("derivs", InterpolationMethod.TRIQUINTIC)]


@pytest.mark.parametrize("kind,method", METHODS)
def test_evaluate_streamed_and_gap_mask_match_jax(files, kind, method):
    """A region's raw grid and its pack, with atoms inside the region,
    in the gap between region and full box, and outside the full box."""
    t, j = _pair(files[kind], method)
    start = np.array([4, 3, 5])
    tgrid, (ilo, ihi) = t._build_region(start)
    jgrid, (jlo, jhi) = j._build_region(start)
    np.testing.assert_array_equal(ilo, jlo)
    np.testing.assert_array_equal(ihi, jhi)
    rng = np.random.default_rng(1)
    pos = np.concatenate([
        _cloud(rng, ilo + 0.4, 6),                          # in the region
        ORIGIN + np.array([[0.1, 0.1, 0.1], [2.7, 2.5, 2.2]]),  # gap
        np.array([[-1.4, 0.0, 0.0], [0.0, 2.4, 3.0]])])     # outside
    scal = rng.uniform(-1.0, 1.0, len(pos))
    scal[2] = 0.0
    full = t.full_box
    got, gap = streaming.evaluate_streamed(
        tgrid, *full, torch.as_tensor(pos), torch.as_tensor(scal), t.oob_k,
        return_gap_mask=True)
    ref, jgap = jstreaming.evaluate_streamed(
        jgrid, *j.full_box, jnp.asarray(pos), jnp.asarray(scal), j.oob_k,
        return_gap_mask=True)
    _close(got, ref)
    np.testing.assert_array_equal(gap.numpy(), np.asarray(jgap))
    assert gap.numpy()[6:8].all() and not gap.numpy()[8:].any()
    if method in (InterpolationMethod.TRILINEAR,
                  InterpolationMethod.BSPLINE):
        got = streaming.evaluate_streamed(
            pack_grid(tgrid), *full, torch.as_tensor(pos[:6]),
            torch.as_tensor(scal[:6]), t.oob_k)
        ref = jstreaming.evaluate_streamed(
            jpack_grid(jgrid), *j.full_box, jnp.asarray(pos[:6]),
            jnp.asarray(scal[:6]), j.oob_k)
        _close(got, ref)


@pytest.mark.parametrize("kind,method", METHODS[1:2] + METHODS[3:])
@pytest.mark.parametrize("oob_convention", ["reference", "cuda-tiled"])
def test_evaluate_sequence_matches_jax(files, kind, method, oob_convention):
    """A drifting cloud (region kept while it fits the interior, then
    re-read), a cloud larger than one region (chunked), and a cloud wholly
    outside: the same results and the same region hits and misses."""
    t, j = _pair(files[kind], method, oob_convention=oob_convention)
    rng = np.random.default_rng(2)
    base = _cloud(rng, (0.3, 0.4, 0.6))
    clouds = [base, base + 0.02, base + 0.05, base + 0.6,
              _cloud(rng, (0.5, 0.5, 0.5), 12, spread=1.4),
              base + np.array([5.0, 0.0, 0.0])]
    scal = rng.uniform(-1.0, 1.0, len(base))
    for pos in clouds:
        s = scal if len(pos) == len(scal) else rng.uniform(-1, 1, len(pos))
        got = t.evaluate(torch.as_tensor(pos), torch.as_tensor(s))
        ref = j.evaluate(jnp.asarray(pos), jnp.asarray(s))
        _close(got, ref)
        assert (t.region_hits, t.region_misses) == (j.region_hits,
                                                    j.region_misses)
    assert t.region_hits >= 1 and t.region_misses >= 3
    assert vars(t.cache_stats()) == vars(j.cache_stats())
    t.close()
    j.close()


@pytest.mark.parametrize("kind,method", METHODS[1:2] + METHODS[3:])
def test_evaluate_batch_matches_jax(files, kind, method):
    """Poses scattered over the box (the docking-screen route), one larger
    than a region and one wholly outside, in two calls (the second hits
    the device region LRU)."""
    t, j = _pair(files[kind], method)
    t.device_regions = j.device_regions = 16
    rng = np.random.default_rng(3)
    n = 7
    centers = rng.uniform(np.array(ORIGIN) + 0.3,
                          np.array(ORIGIN) + 2.2, (9, 3))
    pos = np.stack([_cloud(rng, c, n) for c in centers]
                   + [_cloud(rng, (0.4, 0.4, 0.4), n, spread=1.3),
                      _cloud(rng, (9.0, 9.0, 9.0), n)])
    scal = rng.uniform(-1.0, 1.0, (len(pos), n))
    for _ in range(2):
        got = t.evaluate_batch(torch.as_tensor(pos), torch.as_tensor(scal))
        ref = j.evaluate_batch(jnp.asarray(pos), jnp.asarray(scal))
        _close(got, ref)
        assert (t.region_hits, t.region_misses) == (j.region_hits,
                                                    j.region_misses)
        pos = pos + 0.01
    assert t.region_hits > 0
    assert got.energy.shape == (len(pos),)
    # one scaling row for every replica broadcasts
    got = t.evaluate_batch(torch.as_tensor(pos), torch.as_tensor(scal[0]))
    ref = j.evaluate_batch(jnp.asarray(pos), jnp.asarray(scal[0]))
    _close(got, ref)


def test_hermite_needs_derivatives_and_regions_stay_in_the_grid(files):
    with pytest.raises(ValueError, match="no derivatives"):
        streaming.StreamedGridEvaluator(
            files["values"], InterpolationMethod.TRIQUINTIC, device="cpu")
    ev = streaming.StreamedGridEvaluator(files["values"],
                                         region_shape=(99, 5, 99),
                                         device="cpu")
    assert ev.region_shape == (24, 5, 20)
    assert ev.full_grid_bytes() == 24 * 22 * 20 * 4
    assert streaming._HALO == {int(k): v for k, v in
                               jstreaming._HALO.items()}
