"""K3, the fused evaluation of a pack (ops/cuda_packed_eval.py), on the
host: its plain twin against the JAX package's evaluate_multi (float64),
its slab form against JAX's sharded evaluator, the wrapper's dispatch,
the autograd Function, and the kernel source's entry points. The kernel
itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import chip_smoke
from openmmgridforce_tpu.grid import Grid as JGrid
from openmmgridforce_tpu.ops import packed as jpacked
from openmmgridforce_tpu.parallel import sharded_grid as jsharded
from openmmgridforce_tpu_torch import convert, cuda_build
from openmmgridforce_tpu_torch.grid import InterpolationMethod
from openmmgridforce_tpu_torch.ops import cuda_packed_eval, packed

torch.set_num_threads(1)

COUNTS = (7, 6, 5)
SPACING = (0.1, 0.12, 0.09)
ORIGIN = (-0.3, 0.1, 0.2)
N_ATOMS = 23
REPLICAS = 3
METHODS = ("TRILINEAR", "BSPLINE", "TRICUBIC", "TRIQUINTIC")
HERMITE = ("TRICUBIC", "TRIQUINTIC")


def _grid_set(method, seed=5):
    """Three co-located grids of ``method`` for both packages: the middle
    one with an inverse power (back power 3; values positive), RUNTIME for
    the value methods and STORED for the Hermite ones; random 27
    derivatives for the Hermite methods."""
    rng = np.random.default_rng([seed, METHODS.index(method)])
    m = int(InterpolationMethod[method])
    out = []
    for g in range(3):
        vals = rng.standard_normal(COUNTS) * 20.0
        derivs = (rng.standard_normal(COUNTS + (27,)) * 20.0
                  if method in HERMITE else None)
        kw = dict(interp_method=m, oob_k=500.0)
        if g == 1:
            vals = np.abs(vals) + 1.0
            kw.update(inv_power_mode=2 if method in HERMITE else 1,
                      inv_power=3.0)
        jg = JGrid.create(vals, SPACING, ORIGIN, derivs=derivs,
                          dtype=jnp.float64, **kw)
        tg = convert.grid_from_arrays(vals, SPACING, ORIGIN, derivs=derivs,
                                      device="cpu", **kw)
        out.append((jg, tg))
    return out


def _packs(method, poly_basis):
    grids = _grid_set(method)
    jm = jpacked.combine_packed_grids(
        [jpacked.pack_grid(j, poly_basis=poly_basis) for j, _ in grids])
    tm = packed.combine_packed_grids(
        [packed.pack_grid(t, poly_basis=poly_basis) for _, t in grids])
    assert tm.back_powers == (0.0, 3.0, 0.0)
    return jm, tm


def _inputs(lead=()):
    """chip_smoke's atoms: inside, on the box's corners and on interior
    cell faces of every axis, outside on every side; and scalings [3, N]
    with zeros."""
    x = chip_smoke.packed_eval_positions(29, lead, N_ATOMS)
    return x, chip_smoke.packed_eval_scaling(31, 3, N_ATOMS)


def _assert_close(got, ref, tol=1e-10):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_chip_smoke_geometry_is_this_files():
    assert (chip_smoke.PACKED_EVAL_COUNTS, chip_smoke.PACKED_EVAL_SPACING,
            chip_smoke.PACKED_EVAL_ORIGIN) == (COUNTS, SPACING, ORIGIN)


@pytest.mark.parametrize("lead", [(), (REPLICAS,)])
@pytest.mark.parametrize("poly_basis", ["monomial", "chebyshev"])
@pytest.mark.parametrize("method", METHODS)
def test_plain_matches_jax(method, poly_basis, lead):
    """packed_eval_plain (and evaluate_multi, its CPU route) against the
    JAX package's evaluate_multi at 1e-10, replica by replica: atoms
    outside, on the faces, zero scalings, a back power."""
    jm, tm = _packs(method, poly_basis)
    x, s = _inputs(lead)
    xt = torch.from_numpy(x)
    e, f = cuda_packed_eval.packed_eval_plain(tm, xt, torch.from_numpy(s))
    res = packed.evaluate_multi(tm, xt, s)
    assert torch.equal(res.per_atom_energy, e) and torch.equal(res.forces, f)
    for row in np.ndindex(*lead):
        ref = jpacked.evaluate_multi(jm, jnp.asarray(x[row]), s)
        _assert_close(e[row], ref.per_atom_energy)
        _assert_close(f[row], ref.forces)
        _assert_close(res.energy[row], ref.energy)
    outside = ~np.all((x >= np.asarray(ORIGIN)) & (
        x <= np.asarray(ORIGIN) + np.asarray(SPACING) * (
            np.asarray(COUNTS) - 1)), axis=-1)
    assert outside.any() and (~outside).any()


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's sharded evaluator over 3 of the virtual devices."""
    mesh = JMesh(np.asarray(jax.devices()[:3]), ("sp",))
    return mesh, jax.jit(jsharded.make_sharded_grid_eval(mesh))


@pytest.mark.parametrize("n_sp", [2, 3])
@pytest.mark.parametrize("method", ["BSPLINE", "TRIQUINTIC"])
def test_slab_form_matches_the_sharded_evaluators(jax_sharded, method,
                                                  n_sp):
    """Each rank's window (its rows, its slab of x-cells, the restraint on
    the first only) counts exactly the atoms whose cell it holds: the
    owner gives the whole evaluation's energy and forces bit for bit, the
    others exact zeros, so the ranks' sum is the whole result; that sum
    equals JAX's make_sharded_grid_eval (and the parallel package's
    _eval_local_slab on gloo ranks, tests/test_torch_sharded.py)."""
    jm, tm = _packs(method, "chebyshev")
    x, s = _inputs((REPLICAS,))
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    whole = cuda_packed_eval.packed_eval_plain(tm, xt, st)
    ncx = COUNTS[0] - 1
    slab = -(-ncx // n_sp)
    cell_x = torch.clamp(torch.floor(
        (xt[..., 0] - ORIGIN[0]) / SPACING[0]), 0, ncx - 1)
    inside = torch.all((xt >= torch.tensor(ORIGIN)) & (
        xt <= torch.tensor(ORIGIN) + torch.tensor(SPACING) * (
            torch.tensor(COUNTS) - 1)), dim=-1)
    total = [torch.zeros_like(whole[0]), torch.zeros_like(whole[1])]
    for r in range(n_sp):
        part = chip_smoke.slab_table(tm, r * slab, slab)
        e, f = cuda_packed_eval.packed_eval(part, xt, st, x_lo=r * slab,
                                            x_count=slab, restrain=r == 0)
        mine = inside & (cell_x >= r * slab) & (cell_x < (r + 1) * slab)
        if r == 0:
            mine |= ~inside
        assert torch.equal(e[mine], whole[0][mine])
        assert torch.equal(f[mine], whole[1][mine])
        assert not e[~mine].any() and not f[~mine].any()
        total = [total[0] + e, total[1] + f]
    assert torch.equal(total[0], whole[0]) and torch.equal(total[1],
                                                           whole[1])
    if n_sp == 3:
        mesh, jeval = jax_sharded
        jsh = jsharded.shard_packed_grid(jm, mesh)
        for row in range(REPLICAS):
            ref = jeval(jsh, jnp.asarray(x[row]), jnp.asarray(s))
            _assert_close(total[0][row], ref.per_atom_energy)
            _assert_close(total[1][row], ref.forces)


def test_wrapper_takes_the_plain_twin_on_the_host(monkeypatch):
    """A CPU tensor goes to the plain twin and never to the kernel's
    route; the kernel's route raises on a float16 or bfloat16 pack, an
    unsupported degree and a host tensor before it loads any library."""
    _, tm = _packs("BSPLINE", "monomial")
    x, s = _inputs((REPLICAS,))
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    launched = []
    monkeypatch.setattr(cuda_packed_eval, "_launch",
                        lambda *a: launched.append(a))
    monkeypatch.setattr(cuda_packed_eval, "_library",
                        lambda: pytest.fail("loaded the kernel's library"))
    got = cuda_packed_eval.packed_eval(tm, xt, st)
    ref = cuda_packed_eval.packed_eval_plain(tm, xt, st)
    assert not launched and cuda_packed_eval.packed_eval.launches == 0
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    monkeypatch.undo()
    monkeypatch.setattr(cuda_packed_eval, "_library",
                        lambda: pytest.fail("loaded the kernel's library"))
    window = (0, COUNTS[0] - 1, True)
    for dtype in (torch.float16, torch.bfloat16):
        low = dataclasses.replace(tm, coeffs=tm.coeffs.to(dtype),
                                  spacing=tm.spacing.to(dtype),
                                  origin=tm.origin.to(dtype))
        with pytest.raises(ValueError, match="float32 or float64"):
            cuda_packed_eval._launch(low, xt.to(dtype), st.to(dtype),
                                     *window)
    odd = dataclasses.replace(tm, degree=3, coeffs=torch.zeros(
        (tm.coeffs.shape[0], 3 * 27), dtype=torch.float64))
    with pytest.raises(ValueError, match="degrees"):
        cuda_packed_eval._launch(odd, xt, st, *window)
    with pytest.raises(ValueError, match="no packed_eval kernel for device"):
        cuda_packed_eval._launch(tm, xt, st, *window)
    with pytest.raises(ValueError, match="do not hold"):
        cuda_packed_eval._launch(tm, xt, st, 0, COUNTS[0], True)


@pytest.mark.parametrize("method", ["TRILINEAR", "BSPLINE", "TRIQUINTIC"])
def test_autograd_function_gives_minus_forces(method):
    """PackedEval (the card's differentiable route) on the plain twin:
    gradcheck of the per-atom energies, and the energy's gradient equals
    -forces exactly."""
    _, tm = _packs(method, "chebyshev")
    rng = np.random.default_rng(3)
    lo, hi = np.asarray(ORIGIN), np.asarray(ORIGIN) + np.asarray(
        SPACING) * (np.asarray(COUNTS) - 1)
    x = rng.uniform(lo - 0.1, hi + 0.1, (2, 7, 3))
    s = torch.from_numpy(chip_smoke.packed_eval_scaling(5, 3, 7))
    x = torch.from_numpy(x).requires_grad_(True)
    window = (0, COUNTS[0] - 1, True)

    def energies(pos):
        return cuda_packed_eval.PackedEval.apply(pos, tm, s, *window)[0]

    assert torch.autograd.gradcheck(energies, (x,), eps=1e-6, atol=1e-5,
                                    rtol=1e-4)
    e, f = cuda_packed_eval.PackedEval.apply(x, tm, s, *window)
    assert not f.requires_grad
    e.sum().backward()
    assert torch.equal(x.grad, -f)


def test_float_division_by_a_reciprocal_within_an_ulp():
    """The kernel's float32 division by the spacing: the float64 product
    with a reciprocal within an ulp (either neighbour of the correctly
    rounded one), rounded to float, is IEEE float division, here on
    random operands and on cell faces."""
    rng = np.random.default_rng(7)
    a = np.concatenate([
        rng.uniform(-5.0, 5.0, 200_000),
        (np.arange(1, 2001)[:, None] * np.asarray(SPACING)).ravel()
    ]).astype(np.float32)
    b = np.concatenate([rng.uniform(0.001, 1.0, 200_000),
                        np.tile(np.asarray(SPACING), 2000)]).astype(
                            np.float32)
    want = a / b
    inv = 1.0 / b.astype(np.float64)
    for r in (inv, np.nextafter(inv, 0.0), np.nextafter(inv, 2.0)):
        got = (a.astype(np.float64) * r).astype(np.float32)
        np.testing.assert_array_equal(got, want)


def test_kernel_source_and_library():
    (src,) = cuda_build.LIBRARIES["packed_eval"]
    text = (cuda_build.CSRC / src).read_text()
    assert 'extern "C" int packed_eval_launch(' in text
    assert "__global__" in text
    assert "packed_eval_kernel" in text
    assert cuda_packed_eval.DEGREES == chip_smoke.PACKED_EVAL_DEGREES


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree", cuda_packed_eval.DEGREES)
def test_launch_plan_fits_shared_memory(degree, dtype):
    """The kernel's tile for every degree and dtype and G = 1 to 8: whole
    warps where 8 atoms fit, slots at least a row and 16-byte multiples,
    64 bytes more where the row is a multiple of 128, and a block's shared
    memory (slots and barrier) within the H100's 232,448 bytes; the
    shipped tile for the fused packs of three grids."""
    item = 8 if dtype == torch.float64 else 4
    for n_grids in range(1, 9):
        plan = cuda_packed_eval.launch_plan(degree, n_grids, dtype)
        row = n_grids * degree ** 3 * item
        assert plan.row_bytes == row
        assert plan.slot_bytes == (row + 64 if row % 128 == 0 else row)
        assert plan.slot_bytes % 16 == 0
        assert plan.shared_bytes == plan.tile_atoms * plan.slot_bytes + 16
        assert plan.shared_bytes <= 232_448
        assert plan.threads == 4 * plan.tile_atoms <= 128
        assert 1 <= plan.tile_atoms <= cuda_packed_eval.TILE_ATOMS
        assert plan.tile_atoms % 8 == 0 or plan.tile_atoms < 8
        assert plan.blocks(1000 * 47) == -(-47000 // plan.tile_atoms)
    three = cuda_packed_eval.launch_plan(degree, 3, dtype)
    assert three.tile_atoms == cuda_packed_eval.TILE_ATOMS


def test_launch_plan_shrinks_and_refuses():
    """Rows too wide for the shipped tile take fewer atoms a block, down
    to one; a row wider than a block's shared memory is refused."""
    plan = cuda_packed_eval.launch_plan(6, 20, torch.float64)  # 34,560 B
    assert plan.tile_atoms == 6 and plan.shared_bytes <= 232_448
    plan = cuda_packed_eval.launch_plan(6, 134, torch.float64)
    assert plan.tile_atoms == 1 and plan.shared_bytes <= 232_448
    with pytest.raises(ValueError, match="shared memory"):
        cuda_packed_eval.launch_plan(6, 135, torch.float64)


@pytest.mark.parametrize("n_atoms, replicas", [(47, 1000), (23, 5), (3, 1),
                                               (1, 7)])
def test_atom_order_is_atom_major(n_atoms, replicas):
    """The kernel's atom-major launch order (its kAtomMajor switch)
    against a plain enumeration: every atom once, the replicas of each
    ligand atom side by side in replica order."""
    got = cuda_packed_eval.atom_order(n_atoms * replicas, n_atoms)
    want = [r * n_atoms + n for n in range(n_atoms)
            for r in range(replicas)]
    assert got.tolist() == want
    assert sorted(got.tolist()) == list(range(n_atoms * replicas))


def test_wrapper_refusals_before_the_launch(monkeypatch):
    """What the wrapper refuses of a table before any library loads: a
    row wider than a block's shared memory, back powers that do not
    match the grids, spacing of another dtype."""
    monkeypatch.setattr(cuda_packed_eval, "_library",
                        lambda: pytest.fail("loaded the kernel's library"))
    _, tm = _packs("BSPLINE", "monomial")
    x, s = _inputs((REPLICAS,))
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    window = (0, COUNTS[0] - 1, True)
    wide = dataclasses.replace(
        tm, degree=6, n_grids=135, back_powers=(0.0,) * 135,
        coeffs=torch.zeros((tm.coeffs.shape[0], 135 * 216),
                           dtype=torch.float64))
    with pytest.raises(ValueError, match="shared memory"):
        cuda_packed_eval._launch(wide, xt, st, *window)
    short = dataclasses.replace(tm, back_powers=(0.0,))
    with pytest.raises(ValueError, match="back powers"):
        cuda_packed_eval._launch(short, xt, st, *window)
    mixed = dataclasses.replace(tm, spacing=tm.spacing.float())
    with pytest.raises(ValueError, match="spacing must be"):
        cuda_packed_eval._launch(mixed, xt, st, *window)


def test_registers_of_each_instantiation_from_the_build_log():
    """chip_smoke's names of K3's instantiations from ptxas' mangled
    entry functions: the shipped kernel's (degree, basis, type, grids) and
    the first design's (no grids)."""
    name = chip_smoke.packed_eval_instance
    assert name("_ZN12_GLOBAL__N_118packed_eval_kernelILi6ELb1EfLi3EEEvPKT1_"
                ) == "d6 chebyshev float32 G3"
    assert name("_ZN12_GLOBAL__N_118packed_eval_kernelILi2ELb0EdLi0EEEvPKT1_"
                ) == "d2 monomial float64 G0"
    assert name("_ZN12_GLOBAL__N_118packed_eval_kernelILi4ELb0EfEEvPKT1_"
                ) == "d4 monomial float32"
    assert name("_ZN3abc21gridgen_derivs_kernelILi0EEEvPK6float4") is None
