"""Radial tables, the Cartesian conversion and grid generation against
``torch.autograd``, and generate_grid's memory guard.

The port's counterparts of the JAX package's ``tests/test_radial_gridgen.py``
with PyTorch's autodiff in place of JAX's: an oracle independent of both
packages' chain-rule and tensor machinery, so these hold the port against
calculus. Float64 on the host. The memory guard's cases are the JAX file's,
with the port's budget patched to 1 GB, and a refused request launches and
allocates nothing.
"""

import numpy as np
import pytest
import torch

from openmmgridforce_tpu_torch.grid import InvPowerMode
from openmmgridforce_tpu_torch.ops import (cuda_gridgen, cuda_gridgen_derivs,
                                           gridgen, radial)
from openmmgridforce_tpu_torch.ops.derivatives27 import DERIV_ORDERS
from openmmgridforce_tpu_torch.units import COULOMB_CONST, TWO_POW_ONE_SIXTH

torch.set_num_threads(1)

RNG = np.random.default_rng(2024)


def derivs27_by_autograd(f, point):
    """All 27 mixed partials (orders <= 2 per axis) of scalar f: R^3 -> R
    at ``point``, by nested torch.autograd.grad."""
    p = torch.tensor(point, dtype=torch.float64, requires_grad=True)
    out = np.zeros(27)
    for d, orders in enumerate(DERIV_ORDERS):
        y = f(p)
        for axis, n in enumerate(orders):
            for _ in range(n):
                y = torch.autograd.grad(y, p, create_graph=True)[0][axis]
        out[d] = float(y.detach())
    return out


@pytest.mark.parametrize("grid_type", ["charge", "ljr", "lja"])
def test_radial_derivatives_match_autograd(grid_type):
    q, sigma, eps = (torch.tensor(v, dtype=torch.float64)
                     for v in (0.7, 0.31, 1.2))
    r0 = 0.83
    rad = radial.radial_derivatives(
        torch.tensor(r0 * r0, dtype=torch.float64), grid_type, q, sigma,
        eps).numpy()
    r = torch.tensor(r0, dtype=torch.float64, requires_grad=True)
    y = radial.field_value(r, grid_type, q, sigma, eps)
    for n in range(7):
        assert rad[n] == pytest.approx(float(y.detach()), rel=1e-10), \
            f"order {n}"
        y = torch.autograd.grad(y, r, create_graph=True)[0]


@pytest.mark.parametrize("grid_type", ["charge", "lja"])
def test_cartesian_tensor_conversion_matches_autograd(grid_type):
    """radial_to_cartesian reproduces nested autograd of U(|p - a|)."""
    q, sigma, eps = (torch.tensor(v, dtype=torch.float64)
                     for v in (-0.4, 0.28, 0.9))
    atom = torch.tensor([0.1, -0.2, 0.05], dtype=torch.float64)
    point = np.array([0.6, 0.35, -0.4])

    def field(p):
        r = torch.sqrt(((p - atom) ** 2).sum())
        return radial.field_value(r, grid_type, q, sigma, eps)

    dr = torch.as_tensor(point) - atom
    rad = radial.radial_derivatives((dr * dr).sum(), grid_type, q, sigma,
                                    eps)
    got = radial.radial_to_cartesian(dr, rad).numpy()
    want = derivs27_by_autograd(field, point)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_generate_values_match_direct_sum():
    """Value-only generation against a plain numpy double loop (the
    reference's oracle pattern, test_simple_grid_energy.py:124-184)."""
    counts = (4, 5, 3)
    spacing = (0.1, 0.12, 0.09)
    origin = (0.0, -0.1, 0.2)
    n_atoms = 6
    pos = RNG.uniform(-0.2, 0.6, (n_atoms, 3))
    q = RNG.uniform(-1, 1, n_atoms)
    sig = RNG.uniform(0.2, 0.35, n_atoms)
    eps = RNG.uniform(0.1, 1.0, n_atoms)
    cap = 500.0

    for gt in ["charge", "ljr", "lja"]:
        vals = gridgen.generate_grid(counts, spacing, origin, gt, pos, q,
                                     sig, eps, grid_cap=cap,
                                     dtype=torch.float64,
                                     device="cpu").vals.numpy()
        for _ in range(10):
            i, j, k = (RNG.integers(0, counts[0]), RNG.integers(0, counts[1]),
                       RNG.integers(0, counts[2]))
            gp = np.asarray(origin) + np.array([i, j, k]) * np.asarray(
                spacing)
            total = 0.0
            for a in range(n_atoms):
                r = max(np.linalg.norm(gp - pos[a]), 1e-6)
                if gt == "charge":
                    total += COULOMB_CONST * q[a] / r
                elif gt == "ljr":
                    rmin = TWO_POW_ONE_SIXTH * sig[a]
                    total += np.sqrt(eps[a]) * rmin ** 6 / r ** 12
                else:
                    rmin = TWO_POW_ONE_SIXTH * sig[a]
                    total += -2.0 * np.sqrt(eps[a]) * rmin ** 3 / r ** 6
            want = cap * np.tanh(total / cap)
            assert vals[i, j, k] == pytest.approx(want, rel=1e-10), (gt, i,
                                                                     j, k)


def test_generate_derivatives_match_autograd_field():
    """The whole derivative pipeline (radial tables, tensor conversion,
    tanh chain rule, fractional scaling) against nested autograd of the
    composed capped field."""
    counts = (3, 3, 3)
    spacing = (0.11, 0.1, 0.12)
    origin = (0.3, 0.3, 0.3)
    pos = np.array([[0.0, 0.1, 0.2], [0.8, 0.7, 0.9]])
    q = np.array([0.9, 1.4])
    sig = np.array([0.3, 0.25])
    eps = np.array([0.6, 0.8])
    cap = 50.0  # low cap so some points are in the tanh regime

    derivs = gridgen.generate_grid(counts, spacing, origin, "ljr", pos, q,
                                   sig, eps, compute_derivatives=True,
                                   grid_cap=cap, dtype=torch.float64,
                                   device="cpu").derivs.numpy()
    atoms = torch.as_tensor(pos)
    k = torch.as_tensor(np.sqrt(eps) * (TWO_POW_ONE_SIXTH * sig) ** 6)

    def raw_field(p):
        r2 = ((p[None, :] - atoms) ** 2).sum(-1).clamp_min(4e-4)
        return (k / r2 ** 6).sum()

    def capped_field(p):
        return cap * torch.tanh(raw_field(p) / cap)

    scale = np.array([spacing[0] ** a * spacing[1] ** b * spacing[2] ** c
                      for (a, b, c) in DERIV_ORDERS])
    for (i, j, k_) in [(0, 0, 0), (1, 1, 1), (2, 0, 2)]:
        gp = np.asarray(origin) + np.array([i, j, k_]) * np.asarray(spacing)
        want_phys = derivs27_by_autograd(capped_field, gp)
        if want_phys[0] / cap < 0.1:
            # passthrough branch: raw (uncapped) derivatives stored
            want_phys = derivs27_by_autograd(raw_field, gp)
        np.testing.assert_allclose(derivs[i, j, k_], want_phys * scale,
                                   rtol=1e-7, atol=1e-9)


def test_generate_stored_invpower_values():
    args = ((3, 3, 3), (0.1, 0.1, 0.1), (0.25, 0.25, 0.25), "ljr",
            np.array([[0.0, 0.0, 0.0]]), np.array([1.0]), np.array([0.3]),
            np.array([0.5]))
    n = 2.0
    raw = gridgen.generate_grid(*args, dtype=torch.float64, device="cpu")
    tr = gridgen.generate_grid(*args, inv_power=n,
                               inv_power_mode=InvPowerMode.STORED,
                               dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(tr.vals.numpy(),
                               raw.vals.numpy() ** (1.0 / n), rtol=1e-12)


def _guarded(monkeypatch):
    """generate_grid with the port's budget patched to 1 GB."""
    monkeypatch.setattr(gridgen, "_device_memory_budget",
                        lambda device: 1 << 30)


def test_memory_guard_raises_for_oversized_grids(monkeypatch):
    """A certain device OOM becomes an actionable error naming the tiled
    path (the reference skips derivatives above 80% free GPU memory,
    CudaGridForceKernels.cpp:527-535)."""
    _guarded(monkeypatch)
    with pytest.raises(ValueError, match="tiled"):
        gridgen.generate_grid(
            (512, 512, 512), (0.01,) * 3, (0.0,) * 3, "charge",
            np.zeros((4, 3)), np.ones(4), np.full(4, 0.3), np.ones(4),
            compute_derivatives=True, device="cpu")
    # values only: 640^3 * 4 B * the values factor > 1 GB
    with pytest.raises(ValueError, match="tiled"):
        gridgen.generate_grid(
            (640, 640, 640), (0.01,) * 3, (0.0,) * 3, "charge",
            np.zeros((4, 3)), np.ones(4), np.full(4, 0.3), np.ones(4),
            device="cpu")
    # a small grid passes the guard and generates
    g = gridgen.generate_grid(
        (9, 9, 9), (0.05,) * 3, (0.0,) * 3, "charge",
        np.full((2, 3), 2.0), np.ones(2), np.full(2, 0.3), np.ones(2),
        device="cpu")
    assert torch.isfinite(g.vals).all()


def test_memory_guard_refuses_before_any_work(monkeypatch):
    """A refused request reaches neither kernel nor its plain twin, and
    builds no atom table; the guard's factors are at least the JAX
    package's."""
    _guarded(monkeypatch)

    def refuse(*args, **kwargs):
        raise AssertionError("reached after the guard refused")

    monkeypatch.setattr(gridgen, "receptor_atoms", refuse)
    monkeypatch.setattr(cuda_gridgen, "gridgen_values_plain", refuse)
    monkeypatch.setattr(cuda_gridgen_derivs, "gridgen_derivs_plain", refuse)
    launches = (cuda_gridgen.gridgen_values.launches,
                cuda_gridgen_derivs.gridgen_derivs.launches)
    for counts, derivs in (((512,) * 3, True), ((640,) * 3, False)):
        with pytest.raises(ValueError, match="StreamedGridEvaluator"):
            gridgen.generate_grid(
                counts, (0.01,) * 3, (0.0,) * 3, "charge", np.zeros((4, 3)),
                np.ones(4), np.full(4, 0.3), np.ones(4),
                compute_derivatives=derivs, dtype=torch.float64,
                device="cpu")
    assert launches == (cuda_gridgen.gridgen_values.launches,
                        cuda_gridgen_derivs.gridgen_derivs.launches)
    assert gridgen.GUARD_FACTOR_VALUES >= 2
    assert gridgen.GUARD_FACTOR_DERIVS >= 28 + 27


def test_memory_guard_unbounded_on_the_host():
    assert gridgen._device_memory_budget(torch.device("cpu")) is None


class _StubMesh:
    """The two questions generate_grid_sharded asks of a mesh before it
    generates: rank 0 of 4 on the host."""

    device = torch.device("cpu")

    def size(self, axis):
        return 4

    def index(self, axis):
        return 0


@pytest.mark.parametrize("derivs", [False, True])
def test_sharded_generation_guards_each_rank_slab(monkeypatch, derivs):
    """Each rank's slab is held against that rank's budget: a grid four
    times too large for one rank passes when its slab fits, and a slab
    that does not fit is refused."""
    from openmmgridforce_tpu_torch.parallel.sharded_gridgen import (
        generate_grid_sharded)

    _guarded(monkeypatch)

    def reached(*args, **kwargs):
        raise AssertionError("generation reached")

    monkeypatch.setattr(gridgen, "receptor_atoms", reached)
    factor = (gridgen.GUARD_FACTOR_DERIVS if derivs
              else gridgen.GUARD_FACTOR_VALUES)
    rows = int(0.8 * (1 << 30) / (4 * factor)) // (64 * 64)
    rec = (np.zeros((4, 3)), np.ones(4), np.full(4, 0.3), np.ones(4))
    with pytest.raises(AssertionError, match="generation reached"):
        generate_grid_sharded(_StubMesh(), (4 * rows, 64, 64), (0.01,) * 3,
                              (0.0,) * 3, "charge", *rec,
                              compute_derivatives=derivs)
    with pytest.raises(ValueError, match="tiled"):
        gridgen.generate_grid((4 * rows, 64, 64), (0.01,) * 3, (0.0,) * 3,
                              "charge", *rec, compute_derivatives=derivs,
                              device="cpu")
    with pytest.raises(ValueError, match="tiled"):
        generate_grid_sharded(_StubMesh(), (8 * rows, 64, 64), (0.01,) * 3,
                              (0.0,) * 3, "charge", *rec,
                              compute_derivatives=derivs)


def test_guard_covers_auto_generation_and_spares_the_tiled_route(
        monkeypatch, tmp_path):
    """With no memory at all, a Context's auto-generation is refused by
    the guard, and the tiled route (the way past it) still writes its
    file."""
    import chip_smoke
    import openmmgridforce_tpu_torch.api as gfp

    monkeypatch.setattr(gridgen, "_device_memory_budget", lambda device: 0)
    lig, x, rec, rx = chip_smoke.synthetic_complex(3, n_ligand=10,
                                                   n_receptor=40, gap=0.35)
    system = gfp.create_system(rec, device="cpu")
    f = gfp.GridForce()
    f.addGridCounts(4, 4, 4)
    f.addGridSpacing(0.1, 0.1, 0.1)
    f.setGridOrigin(*x.min(0))
    f.setAutoGenerateGrid(True)
    f.setGridType("charge")
    f.setReceptorAtoms(list(range(40)))
    f.setReceptorPositionsFromLists(rx)
    f.setScalingFactors(np.zeros(40))
    system.addForce(f)
    with pytest.raises(ValueError, match="generate_grid_to_tiled_file"):
        gfp.Context(system, gfp.VerletIntegrator(0.001),
                    gfp.Platform.getPlatformByName("CUDA"), device="cpu")

    path = str(tmp_path / "g.tiled")
    gridgen.generate_grid_to_tiled_file(
        path, (4, 4, 4), (0.1,) * 3, tuple(x.min(0)), "charge", rx,
        rec.charges, rec.sigmas, rec.epsilons, tile_size=4, device="cpu")
    from openmmgridforce_tpu_torch.io import TiledGridReader
    with TiledGridReader(path) as r:
        vals, _ = r.read_full()
    assert vals.shape == (4, 4, 4) and np.isfinite(vals).all()
