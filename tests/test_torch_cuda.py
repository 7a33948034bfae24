"""Checks of the port that need an NVIDIA GPU (marker ``cuda``; skipped
without one). This file imports no JAX, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from openmmgridforce_tpu_torch.ops import (cuda_gridgen, cuda_gridgen_derivs,
                                           cuda_packed_eval, gridgen, packed)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("grid_type", ["charge", "ljr", "lja"])
def test_kernel_matches_plain_twin(cuda, grid_type):
    rng = np.random.default_rng(53)
    n = 301                                   # not a multiple of the tile
    atoms = gridgen.receptor_atoms(
        grid_type, rng.uniform(-0.3, 1.2, (n, 3)), rng.uniform(-1, 1, n),
        rng.uniform(0.2, 0.35, n), rng.uniform(0.1, 1.0, n), device=cuda)
    args = ((19, 21, 23), (0.1, 0.11, 0.09), (0.0, -0.2, 0.3), grid_type,
            800.0)
    before = cuda_gridgen.gridgen_values.launches
    got = cuda_gridgen.gridgen_values(atoms, *args)
    ref = cuda_gridgen.gridgen_values_plain(atoms, *args)
    torch.cuda.synchronize()
    assert cuda_gridgen.gridgen_values.launches == before + 1
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_cap_on_atom_and_dtype_rules(cuda):
    """The cap exactly on an atom in both instantiations; float64 takes
    the float64 kernel (also through generate_grid); other dtypes
    raise."""
    on_atom = torch.tensor([[0.1, 0.1, 0.1, 1.0]], device=cuda)
    for atoms in (on_atom, on_atom.double()):
        got = cuda_gridgen.gridgen_values(atoms, (3, 3, 3), (0.1,) * 3,
                                          (0.0,) * 3, "ljr", 500.0)
        assert got.dtype == atoms.dtype and float(got[1, 1, 1]) == 500.0
    with pytest.raises(ValueError, match="float32 or float64"):
        cuda_gridgen.gridgen_values(on_atom.half(), (3, 3, 3), (0.1,) * 3,
                                    (0.0,) * 3, "ljr", 500.0)
    before = cuda_gridgen.gridgen_values.launches
    g = gridgen.generate_grid((3, 3, 3), (0.1,) * 3, (0.0,) * 3, "ljr",
                              np.array([[0.1] * 3]), [0.0], [0.3], [1.0],
                              dtype=torch.float64, device=cuda)
    assert cuda_gridgen.gridgen_values.launches == before + 1
    assert g.vals.dtype == torch.float64 and g.vals.is_cuda


@pytest.mark.parametrize("n_atoms", chip_smoke.RAGGED_ATOMS)
@pytest.mark.parametrize("counts", chip_smoke.RAGGED_COUNTS)
def test_values_kernel_on_ragged_shapes(cuda, counts, n_atoms):
    """Grids and atom counts that are multiples of no tile, block or
    partial, down to one point and one atom: 1e-5 of the twin's largest
    value, every grid type."""
    geom = (counts, chip_smoke.RAGGED_SPACING, chip_smoke.RAGGED_ORIGIN)
    for grid_type in chip_smoke.GRID_TYPES:
        atoms = chip_smoke.ragged_case(grid_type, counts, n_atoms,
                                       device=cuda)
        args = (atoms, *geom, grid_type, chip_smoke.RAGGED_CAP)
        got = cuda_gridgen.gridgen_values(*args)
        ref = cuda_gridgen.gridgen_values_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == counts
        assert bool(torch.isfinite(got).all())
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


@pytest.mark.parametrize("counts", chip_smoke.RAGGED_COUNTS)
def test_cap_on_the_last_point_of_ragged_grids(cuda, counts):
    last = [c - 1 for c in counts]
    point = (torch.tensor(chip_smoke.RAGGED_ORIGIN)
             + torch.tensor(last) * torch.tensor(chip_smoke.RAGGED_SPACING))
    on_atom = torch.cat([point, torch.ones(1)])[None].to(cuda)
    got = cuda_gridgen.gridgen_values(
        on_atom, counts, chip_smoke.RAGGED_SPACING, chip_smoke.RAGGED_ORIGIN,
        "ljr", chip_smoke.RAGGED_CAP)
    assert float(got[tuple(last)]) == chip_smoke.RAGGED_CAP


def _receptor(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.3, 1.2, (n, 3)), rng.uniform(-1, 1, n),
            rng.uniform(0.2, 0.35, n), rng.uniform(0.1, 1.0, n))


def _slot_err(got, ref):
    got, ref = got.double().reshape(-1, 27), ref.double().reshape(-1, 27)
    return float(((got - ref).abs().amax(0)
                  / ref.abs().amax(0).clamp_min(1e-300)).max())


@pytest.mark.parametrize("grid_type", ["charge", "ljr", "lja"])
def test_derivs_kernel_matches_plain_twin(cuda, grid_type):
    """5e-5 of each slot's max against the float32 twin, 2e-4 against the
    float64 twin; 301 atoms and 9177 points are multiples of no tile."""
    atoms = gridgen.receptor_atoms(grid_type, *_receptor(53, 301),
                                   device=cuda)
    args = ((19, 21, 23), (0.1, 0.11, 0.09), (0.0, -0.2, 0.3), grid_type)
    before = cuda_gridgen_derivs.gridgen_derivs.launches
    got = cuda_gridgen_derivs.gridgen_derivs(atoms, *args)
    ref = cuda_gridgen_derivs.gridgen_derivs_plain(atoms, *args)
    ref64 = cuda_gridgen_derivs.gridgen_derivs_plain(atoms.double(), *args)
    torch.cuda.synchronize()
    assert cuda_gridgen_derivs.gridgen_derivs.launches == before + 1
    assert got.shape == (19, 21, 23, 27) and got.dtype == torch.float32
    assert _slot_err(got, ref) < 5e-5
    assert _slot_err(got, ref64) < 2e-4


@pytest.mark.parametrize("n_atoms", chip_smoke.RAGGED_ATOMS)
@pytest.mark.parametrize("counts", chip_smoke.RAGGED_COUNTS)
def test_derivs_kernel_on_ragged_shapes(cuda, counts, n_atoms):
    """The same ragged shapes for the derivative kernel, at its two gates,
    every grid type."""
    geom = (counts, chip_smoke.RAGGED_SPACING, chip_smoke.RAGGED_ORIGIN)
    for grid_type in chip_smoke.GRID_TYPES:
        atoms = chip_smoke.ragged_case(grid_type, counts, n_atoms,
                                       device=cuda)
        got = cuda_gridgen_derivs.gridgen_derivs(atoms, *geom, grid_type)
        ref = cuda_gridgen_derivs.gridgen_derivs_plain(atoms, *geom,
                                                       grid_type)
        ref64 = cuda_gridgen_derivs.gridgen_derivs_plain(atoms.double(),
                                                         *geom, grid_type)
        torch.cuda.synchronize()
        assert got.shape == counts + (27,)
        assert bool(torch.isfinite(got).all())
        assert _slot_err(got, ref) < 5e-5
        assert _slot_err(got, ref64) < 2e-4


@pytest.mark.parametrize("lj_convention", ["rmin", "diameter"])
def test_generate_grid_with_derivatives_launches_the_kernel(cuda,
                                                            lj_convention):
    """A CUDA float32 generate_grid(compute_derivatives=True) goes through
    the kernel, and agrees with the CPU route (the field laws in float32)
    at the float32 gate of 5e-5 per slot."""
    pos, q, sig, eps = _receptor(7, 40)
    args = ((10, 9, 8), (0.1,) * 3, (0.0, -0.1, 0.1), "ljr", pos, q, sig,
            eps)
    kw = dict(compute_derivatives=True, grid_cap=800.0,
              lj_convention=lj_convention)
    before = (cuda_gridgen_derivs.gridgen_derivs.launches,
              cuda_gridgen.gridgen_values.launches)
    got = gridgen.generate_grid(*args, device=cuda, **kw)
    assert (cuda_gridgen_derivs.gridgen_derivs.launches,
            cuda_gridgen.gridgen_values.launches) == (before[0] + 1,
                                                      before[1])
    assert got.derivs.is_cuda and torch.equal(got.vals, got.derivs[..., 0])
    ref = gridgen.generate_grid(*args, device="cpu", **kw)
    assert _slot_err(got.derivs.cpu(), ref.derivs) < 5e-5
    # float64 runs the kernel's float64 instantiation, to 1e-10 of the
    # host's float64 route
    got = gridgen.generate_grid(*args, dtype=torch.float64, device=cuda,
                                **kw)
    ref = gridgen.generate_grid(*args, dtype=torch.float64, device="cpu",
                                **kw)
    assert cuda_gridgen_derivs.gridgen_derivs.launches == before[0] + 2
    assert got.derivs.dtype == torch.float64
    assert _slot_err(got.derivs.cpu(), ref.derivs) < 1e-10


def test_constraints_on_the_card_match_the_host(cuda):
    """Batched SHAKE and RATTLE in float64 on the card against the host:
    the same results within rounding (the card's fixed-order row sums add
    in another order than the host's index_add_) and the same sweep
    counts, on two calls with other inputs (the card's kernel reads the
    tables the first call built)."""
    from openmmgridforce_tpu_torch.mm import constraints, system

    lig, x, _, _ = chip_smoke.synthetic_complex(5, n_ligand=23,
                                                n_receptor=10)
    sets = {dev: system.system_from_amber(lig, hydrogen_mass=4.0,
                                          constraints="HBonds",
                                          device=dev).constraints
            for dev in ("cpu", cuda)}
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        x_ref = x + 0.003 * rng.standard_normal((6,) + x.shape)
        x_new = x_ref + 0.004 * rng.standard_normal(x_ref.shape)
        v = rng.standard_normal(x_ref.shape)
        out = {}
        for dev, cs in sets.items():
            xs, ns = constraints.apply_shake(
                cs, torch.as_tensor(x_ref, device=dev),
                torch.as_tensor(x_new, device=dev))
            vs, nr = constraints.apply_rattle(cs, xs,
                                              torch.as_tensor(v, device=dev))
            out[str(dev)[:4]] = [t.cpu() for t in (xs, ns, vs, nr)]
        for a, b in zip(out["cpu"], out["cuda"]):
            if a.dtype == torch.int64:
                assert torch.equal(a, b)
            else:
                np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                           atol=1e-12)


def test_pack_grids_fused_on_the_card(cuda):
    """Slabs packed on the card from grids on the host equal the whole
    packs fused on the card."""
    from openmmgridforce_tpu_torch import convert
    from openmmgridforce_tpu_torch.ops import packed

    rng = np.random.default_rng(2)
    grids = [convert.grid_from_arrays(rng.standard_normal((9, 8, 7)) * 50,
                                      (0.1,) * 3, (0.0,) * 3,
                                      interp_method=1, dtype=torch.float32,
                                      device="cpu") for _ in range(3)]
    got = packed.pack_grids_fused(grids, x_chunk=3, device=cuda)
    ref = packed.combine_packed_grids(
        [packed.pack_grid(convert.grid_from_arrays(
            g.vals.numpy(), (0.1,) * 3, (0.0,) * 3, interp_method=1,
            dtype=torch.float32, device=cuda)) for g in grids])
    assert got.coeffs.device.type == "cuda"
    np.testing.assert_allclose(got.coeffs.cpu().numpy(),
                               ref.coeffs.cpu().numpy(), rtol=1e-6,
                               atol=1e-6 * float(ref.coeffs.abs().max()))


@pytest.mark.parametrize("grid_type", ["charge", "ljr", "lja"])
def test_float64_kernels_match_their_twins(cuda, grid_type):
    """Both kernels' float64 instantiations against the float64 twins:
    1e-10 of the largest value (K1) and of each slot's largest (K2)."""
    atoms = gridgen.receptor_atoms(grid_type, *_receptor(54, 301),
                                   dtype=torch.float64, device=cuda)
    args = ((19, 21, 23), (0.1, 0.11, 0.09), (0.0, -0.2, 0.3), grid_type)
    got = cuda_gridgen.gridgen_values(atoms, *args, 800.0)
    ref = cuda_gridgen.gridgen_values_plain(atoms, *args, 800.0)
    assert got.dtype == torch.float64
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-10
    got = cuda_gridgen_derivs.gridgen_derivs(atoms, *args)
    ref = cuda_gridgen_derivs.gridgen_derivs_plain(atoms, *args)
    assert got.dtype == torch.float64
    assert _slot_err(got, ref) < 1e-10


def test_float64_reciprocals_are_within_an_ulp(cuda):
    """float64 K1's Newton-finished 1/sqrt(x) and 1/x from the card's MUFU
    seeds, over r^2 in [1e-12, 1e4], against the correctly rounded values;
    the seeds come in the MUFU's format (the low word zero) and within
    the error the host tests start from."""
    out = chip_smoke.float64_reciprocal_probe(torch)
    assert max(out["max_ulps"].values()) <= chip_smoke.F64_RECIPROCAL_ULPS
    assert out["seed_low_word_zero"]
    for name, err in out["seed_rel_err"].items():
        assert err <= chip_smoke.F64_SEED_REL_ERR[name], name


def test_float64_pairs_are_within_their_ulps(cuda):
    """float64 K1 on single atoms (the clamp from both sides, the far
    field, both sides of the near-line vote) against the correctly rounded
    K / r^p."""
    out = chip_smoke.float64_pair_ulps(torch)
    for gt, row in out["per_grid_type"].items():
        assert row["kernel_vs_exact"] <= chip_smoke.F64_PAIR_ULPS[gt], gt


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_index_offset_gives_the_slice_of_the_whole_grid(cuda, dtype):
    """A launch at index offset (i0, j0, k0) computes exactly the same
    slice of the whole grid, bit for bit, in both kernels."""
    atoms = gridgen.receptor_atoms("lja", *_receptor(55, 200), dtype=dtype,
                                   device=cuda)
    geom = ((19, 21, 23), (0.1, 0.11, 0.09), (0.0, -0.2, 0.3))
    whole = cuda_gridgen.gridgen_values(atoms, *geom, "lja", 800.0)
    whole_d = cuda_gridgen_derivs.gridgen_derivs(atoms, *geom, "lja")
    for off, shape in (((7, 0, 0), (4, 21, 23)), ((2, 9, 11), (3, 5, 6)),
                       ((18, 20, 22), (1, 1, 1))):
        sl = tuple(slice(o, o + n) for o, n in zip(off, shape))
        part = cuda_gridgen.gridgen_values(atoms, shape, *geom[1:], "lja",
                                           800.0, index_offset=off)
        assert torch.equal(part, whole[sl])
        part = cuda_gridgen_derivs.gridgen_derivs(atoms, shape, *geom[1:],
                                                  "lja", index_offset=off)
        assert torch.equal(part, whole_d[sl])


@pytest.mark.parametrize("derivatives", [False, True])
def test_tiled_file_equals_in_memory_generation(cuda, tmp_path,
                                                derivatives):
    """generate_grid_to_tiled_file on the card (slabs of tiles of 8, the
    derivative slabs cut along y by a small budget) holds exactly the grid
    that generate_grid returns."""
    from openmmgridforce_tpu_torch.io import TiledGridReader

    args = ((19, 21, 23), (0.1, 0.11, 0.09), (0.0, -0.2, 0.3), "ljr",
            *_receptor(56, 120))
    path = str(tmp_path / "g.tiled")
    before = (cuda_gridgen.gridgen_values.launches,
              cuda_gridgen_derivs.gridgen_derivs.launches)
    gridgen.generate_grid_to_tiled_file(
        path, *args, tile_size=8, compute_derivatives=derivatives,
        grid_cap=800.0, device=cuda, slab_budget_bytes=1 << 20)
    after = (cuda_gridgen.gridgen_values.launches,
             cuda_gridgen_derivs.gridgen_derivs.launches)
    assert after[int(derivatives)] > before[int(derivatives)]
    mem = gridgen.generate_grid(*args, compute_derivatives=derivatives,
                                grid_cap=800.0, device=cuda)
    with TiledGridReader(path) as r:
        vals, derivs = r.read_full()
    np.testing.assert_array_equal(vals, mem.vals.cpu().numpy())
    if derivatives:
        np.testing.assert_array_equal(
            derivs, np.moveaxis(mem.derivs.cpu().numpy(), -1, 0))


def test_streamed_batch_md_on_the_card_matches_the_host(cuda, tmp_path):
    """StreamedBatchMD in float64 on the card against the host: scattered
    replicas, friction 0, the same trajectories within rounding and the
    same region bookkeeping."""
    from openmmgridforce_tpu_torch import convert
    from openmmgridforce_tpu_torch.grid import InterpolationMethod
    from openmmgridforce_tpu_torch.io import write_grid_tiled
    from openmmgridforce_tpu_torch.io.streaming import StreamedGridEvaluator
    from openmmgridforce_tpu_torch.mm import StreamedBatchMD, system

    lig, x, _, _ = chip_smoke.synthetic_complex(3, n_ligand=10,
                                                n_receptor=10)
    x = x - x.min(0)
    rec = _receptor(57, 15)
    paths, scals = [], []
    for gt in ("charge", "lja"):
        g = gridgen.generate_grid((33, 33, 33), (0.125,) * 3, (-1.0,) * 3,
                                  gt, *rec, grid_cap=400.0,
                                  dtype=torch.float64, device="cpu")
        paths.append(str(tmp_path / f"{gt}.tiled"))
        write_grid_tiled(paths[-1], g, tile_size=8)
        scals.append(gridgen.auto_scaling_factors(gt, lig.charges,
                                                  lig.sigmas, lig.epsilons))
    offsets = np.array([[0.0, 0.0, 0.0], [1.3, 0.1, 0.2], [0.1, 1.4, 0.1],
                        [5.0, 5.0, 5.0]])
    pos = np.stack([x + off for off in offsets])
    out, books = {}, {}
    for dev in ("cpu", cuda):
        evs = [StreamedGridEvaluator(p, InterpolationMethod.BSPLINE,
                                     region_shape=(20, 20, 20),
                                     dtype=torch.float64, device=dev)
               for p in paths]
        md = StreamedBatchMD(evs, scals, system.system_from_amber(
            lig, dtype=torch.float64, device=dev), dt=0.0005, friction=0.0,
            refresh_steps=10)
        states = convert.states_from_arrays(pos, np.zeros_like(pos),
                                            seed=0, device=dev)
        states = md.run(states, 0.0, 30)
        out[str(dev)[:4]] = states.positions.cpu().numpy()
        books[str(dev)[:4]] = convert.stream_set_bookkeeping(md.sets[0])
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=1e-9)
    for key, value in books["cpu"].items():
        np.testing.assert_array_equal(books["cuda"][key], value)


# ----------------------------------------------------------------------
# K3: the fused evaluation of a pack
# ----------------------------------------------------------------------

def _k3_case(cuda, degree, poly_basis, n_grids, dtype, lead=(), seed=11):
    table = chip_smoke.random_pack(seed, degree, poly_basis, n_grids, dtype,
                                   cuda)
    x = torch.as_tensor(chip_smoke.packed_eval_positions(seed + 2, lead),
                        dtype=dtype, device=cuda)
    s = torch.as_tensor(chip_smoke.packed_eval_scaling(seed + 6, n_grids),
                        dtype=dtype, device=cuda)
    return table, x, s


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("poly_basis", chip_smoke.PACKED_EVAL_BASES)
@pytest.mark.parametrize("degree", chip_smoke.PACKED_EVAL_DEGREES)
def test_packed_eval_matches_plain_twin(cuda, degree, poly_basis, dtype):
    """K3 against its plain twin on the card (G = 1 and 3, leading dims []
    and [R]; atoms inside, on the box's faces and outside, zero scalings,
    a back power) at chip_smoke's gates, one launch a call; and
    evaluate_multi on a CUDA pack goes through it."""
    gate = chip_smoke.PACKED_EVAL_GATE[str(dtype).rsplit(".", 1)[-1]]
    for n_grids in (1, 3):
        for lead in ((), (chip_smoke.PACKED_EVAL_REPLICAS,)):
            table, x, s = _k3_case(cuda, degree, poly_basis, n_grids, dtype,
                                   lead)
            before = cuda_packed_eval.packed_eval.launches
            got = cuda_packed_eval.packed_eval(table, x, s)
            multi = packed.evaluate_multi(table, x, s)
            ref = cuda_packed_eval.packed_eval_plain(table, x, s)
            torch.cuda.synchronize()
            assert cuda_packed_eval.packed_eval.launches == before + 2
            assert got[0].shape == x.shape[:-1] and got[1].shape == x.shape
            assert torch.equal(multi.per_atom_energy, got[0])
            assert torch.equal(multi.forces, got[1])
            err = chip_smoke.packed_eval_errors(got, ref)
            assert err["E_rel"] <= gate and err["F_rel"] <= gate, err


def test_packed_eval_raises_on_what_it_does_not_take(cuda):
    """float16 and bfloat16 packs and unsupported degrees raise on the
    card; nothing gives way to the plain twin."""
    table, x, s = _k3_case(cuda, 4, "monomial", 3, torch.float32)
    before = cuda_packed_eval.packed_eval.launches
    for dtype in (torch.float16, torch.bfloat16):
        low = dataclasses.replace(table, coeffs=table.coeffs.to(dtype),
                                  spacing=table.spacing.to(dtype),
                                  origin=table.origin.to(dtype))
        with pytest.raises(ValueError, match="float32 or float64"):
            packed.evaluate_multi(low, x, s)
    odd = dataclasses.replace(table, degree=3, coeffs=torch.zeros(
        (table.coeffs.shape[0], 3 * 27), device=cuda))
    with pytest.raises(ValueError, match="degrees"):
        packed.evaluate_multi(odd, x, s)
    assert cuda_packed_eval.packed_eval.launches == before


def test_packed_eval_autograd_on_the_card(cuda):
    """On the card the energy is differentiable in the positions: the
    gradient is -forces, through evaluate_multi and through
    mm.system.potential_energy on a K3 pack."""
    from openmmgridforce_tpu_torch.mm import system

    table, x, s = _k3_case(cuda, 6, "chebyshev", 3, torch.float64, (3,))
    x.requires_grad_(True)
    res = packed.evaluate_multi(table, x, s)
    res.energy.sum().backward()
    assert torch.equal(x.grad, -res.forces)

    pos, ts, binding = _ladder_system(cuda, torch.float32)
    p = torch.as_tensor(pos, dtype=torch.float32, device=cuda)
    p = p.expand(2, *p.shape).clone().requires_grad_(True)
    system.potential_energy(ts, [binding], p).sum().backward()
    want = system.energy_and_forces(ts, [binding], p.detach())[1]
    scale = float(want.abs().max())
    assert float((p.grad + want).abs().max()) <= 1e-4 * scale


def _sharded_k3_worker(device):
    """A K3 pack split over 2 ranks (gloo) on the card, evaluated there;
    and the launches each rank made."""
    from openmmgridforce_tpu_torch.parallel import (Mesh,
                                                    make_sharded_grid_eval,
                                                    shard_packed_grid)

    mesh = Mesh((2,), ("sp",), device)
    table, x, s = _k3_case(device, 6, "chebyshev", 3, torch.float32, (4,))
    before = cuda_packed_eval.packed_eval.launches
    res = make_sharded_grid_eval(mesh)(shard_packed_grid(table, mesh), x, s)
    return {"energy": res.energy, "forces": res.forces,
            "per_atom": res.per_atom_energy,
            "launches": cuda_packed_eval.packed_eval.launches - before}


def test_sharded_k3_window_on_the_card_matches_one_rank(cuda):
    """Two gloo ranks on cuda:0 each launch K3 once on their slab window;
    the all-reduced result equals one rank's evaluate_multi bit for bit."""
    from openmmgridforce_tpu_torch.parallel import distributed

    ranks = distributed.launch(_sharded_k3_worker, 2, backend="gloo")
    one = packed.evaluate_multi(*_k3_case(cuda, 6, "chebyshev", 3,
                                          torch.float32, (4,)))
    for r in ranks:
        assert r["launches"] == 1
        assert torch.equal(r["per_atom"], one.per_atom_energy.cpu())
        assert torch.equal(r["forces"], one.forces.cpu())
        assert torch.equal(r["energy"], one.energy.cpu())


def _k3_against_twin(table, x, s, *window):
    """K3 and its twin on one case: K3's result, after gating it at
    chip_smoke's tolerance of the dtype."""
    gate = chip_smoke.PACKED_EVAL_GATE[str(x.dtype).rsplit(".", 1)[-1]]
    got = cuda_packed_eval.packed_eval(table, x, s, *window)
    ref = cuda_packed_eval.packed_eval_plain(table, x, s, *window)
    torch.cuda.synchronize()
    assert got[0].shape == x.shape[:-1] and got[1].shape == x.shape
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
    err = chip_smoke.packed_eval_errors(got, ref)
    assert err["E_rel"] <= gate and err["F_rel"] <= gate, err
    return got


# atoms a replica and leading dims: a ragged last tile (115 atoms), fewer
# atoms than one tile, one replica (R = 1 and no leading dim), many tiles
K3_TILINGS = [(23, (5,)), (5, ()), (7, (1,)), (23, ()), (47, (40,))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree", chip_smoke.PACKED_EVAL_DEGREES)
@pytest.mark.parametrize("n_atoms, lead", K3_TILINGS)
def test_packed_eval_tiles(cuda, n_atoms, lead, degree, dtype):
    """K3 against its twin where the atoms do not fill whole tiles, for
    G = 1 to 4 (G = 4 takes the runtime grid loop); the atoms of
    packed_eval_positions lie inside, on the box's faces and outside, so
    a tile mixes atoms that read a row with atoms that read none."""
    for n_grids in (1, 2, 3, 4):
        table = chip_smoke.random_pack(11, degree, "chebyshev", n_grids,
                                       dtype, cuda)
        x = torch.as_tensor(chip_smoke.packed_eval_positions(
            13, lead, n_atoms), dtype=dtype, device=cuda)
        s = torch.as_tensor(chip_smoke.packed_eval_scaling(
            17, n_grids, n_atoms), dtype=dtype, device=cuda)
        _k3_against_twin(table, x, s)


def test_packed_eval_tiles_outside_the_box(cuda):
    """Tiles whose atoms all lie outside the box (no copy in flight) and
    tiles that mix them with atoms inside: the restraint alone, or the
    rows and the restraint, as the twin gives them."""
    table, x, s = _k3_case(cuda, 6, "chebyshev", 3, torch.float32, (40,))
    x[:20] += 5.0                          # whole tiles outside
    x[20:30, ::2] -= 5.0                   # every other atom outside
    got = _k3_against_twin(table, x, s)
    assert bool((got[0][:20] > 0.0).all())  # the restraint's energy


def test_packed_eval_float64_at_its_largest_tile(cuda, monkeypatch):
    """Float64 d = 6 with 4 grids (6,912-byte rows, 6,976-byte slots) at
    32 atoms a block: 223,248 bytes of shared memory, past the 48 KB a
    launch gets without asking; then at the shipped tile again."""
    monkeypatch.setattr(cuda_packed_eval, "TILE_ATOMS", 32)
    plan = cuda_packed_eval.launch_plan(6, 4, torch.float64)
    assert plan.tile_atoms == 32 and plan.shared_bytes == 223_248
    table, x, s = _k3_case(cuda, 6, "chebyshev", 4, torch.float64, (9,))
    _k3_against_twin(table, x, s)
    monkeypatch.undo()
    _k3_against_twin(table, x, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_packed_eval_slab_windows_in_tiles(cuda, dtype):
    """The slab windows of 3 ranks over 40 replicas: each within the gate
    of the twin's window, their sum equal to the whole bit for bit."""
    table, x, s = _k3_case(cuda, 6, "chebyshev", 3, dtype, (40,))
    ncx = chip_smoke.PACKED_EVAL_COUNTS[0] - 1
    whole = _k3_against_twin(table, x, s)
    slab = -(-ncx // 3)
    parts = [_k3_against_twin(chip_smoke.slab_table(table, r * slab, slab),
                              x, s, r * slab, slab, r == 0)
             for r in range(3)]
    for i in (0, 1):
        assert torch.equal(sum(p[i] for p in parts), whole[i])


def test_packed_eval_shared_scaling_reads_one_row(cuda):
    """A [1, N] scaling (one row for every grid, read with a grid stride
    of 0) gives what the same row repeated for every grid gives."""
    table, x, s = _k3_case(cuda, 4, "monomial", 3, torch.float32, (6,))
    row = s[:1]
    one = cuda_packed_eval.packed_eval(table, x, row)
    many = cuda_packed_eval.packed_eval(table, x, row.expand(3, -1))
    assert torch.equal(one[0], many[0]) and torch.equal(one[1], many[1])
    _k3_against_twin(table, x, row)


@pytest.mark.parametrize("degree", chip_smoke.PACKED_EVAL_DEGREES)
def test_packed_eval_recorded_call_equals_eager(cuda, degree):
    """One K3 call recorded as a CUDA graph and replayed gives the eager
    call's energies and forces bit for bit."""
    table, x, s = _k3_case(cuda, degree, "chebyshev", 3, torch.float32,
                           (40,))
    eager = cuda_packed_eval.packed_eval(table, x, s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        recorded = cuda_packed_eval.packed_eval(table, x, s)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(recorded[0], eager[0])
    assert torch.equal(recorded[1], eager[1])


# of the largest |value| of the state: the kernel repeats the twin's
# operations in the twin's order, so float64 agrees to rounding alone;
# float32 within a few ulps, room for a sum inside ATen's reductions that
# adds in another order than the kernel assumes
CONSTRAINT_GATE = {torch.float32: 4 * torch.finfo(torch.float32).eps,
                   torch.float64: 1e-12}


@pytest.mark.parametrize("omega", [1.0, 1.2])
@pytest.mark.parametrize("replicas", [21, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["shake", "rattle"])
def test_constraint_kernel_matches_the_twin_on_the_card(cuda, kind, dtype,
                                                        replicas, omega):
    """The kernel (``apply_shake`` / ``apply_rattle`` on the card) against
    the plain twin run on the card, on the ladder's 47-atom ligand with
    its 27 HBonds constraints, for caps 150, 6 and 3: each replica's
    sweeps equal, the state within CONSTRAINT_GATE, one launch a call,
    and the call counted with its slowest replica's sweeps."""
    from openmmgridforce_tpu_torch.mm import constraints
    from openmmgridforce_tpu_torch.ops import cuda_constraints as cc

    system, x = _bench_ligand(cuda, dtype, "hbonds", replicas)
    cs = system.constraints
    rng = np.random.default_rng(replicas)
    noise = torch.as_tensor(rng.standard_normal(x.shape), dtype=dtype,
                            device=cuda)
    if kind == "shake":
        ref, state = x, x + 0.004 * noise
        apply, plain = constraints.apply_shake, constraints.shake_plain
        wrapper = cc.constraint_shake
    else:
        ref, _ = constraints.shake_plain(cs, x, x + 0.004 * noise)
        state = noise
        apply, plain = constraints.apply_rattle, constraints.rattle_plain
        wrapper = cc.constraint_rattle
    for max_iter in (150, 6, 3):
        apply.stats.reset()
        before = wrapper.launches
        got, sweeps = apply(cs, ref, state, max_iter=max_iter, omega=omega)
        want, want_sweeps = plain(cs, ref, state, max_iter=max_iter,
                                  omega=omega)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert torch.equal(sweeps, want_sweeps), max_iter
        assert torch.isfinite(got).all()
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= CONSTRAINT_GATE[dtype], (max_iter, err)
        out = apply.stats.summary()
        assert (out["calls"], out["max_executed"]) == (
            1, int(want_sweeps.max()))
        assert out["mean_sweeps"] == pytest.approx(
            float(want_sweeps.double().mean()))
    apply.stats.reset()


def _star_chain(n_atoms, seed):
    """A ConstraintSet's arrays and a geometry that take the kernel's
    general paths: atom 0 bonded to six atoms (more rows than an atom
    keeps in registers), then a chain through every atom (more
    constraints and atoms than a block's 256 threads)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n_atoms, 3))
    x[1:7] = 0.11 * np.eye(3)[np.arange(6) % 3] * np.where(
        np.arange(6) < 3, 1.0, -1.0)[:, None]
    for a in range(7, n_atoms):
        step = rng.standard_normal(3)
        x[a] = x[a - 1] + 0.15 * step / np.linalg.norm(step)
    idx = np.array([(0, k) for k in range(1, 7)]
                   + [(a - 1, a) for a in range(7, n_atoms)])
    length = np.linalg.norm(x[idx[:, 0]] - x[idx[:, 1]], axis=1)
    inv_mass = 1.0 / rng.uniform(1.0, 16.0, n_atoms)
    return idx, length, inv_mass, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_atoms", [300, 1500])
def test_constraint_kernel_takes_any_shape_that_fits(cuda, n_atoms, dtype):
    """The kernel's general paths against the twin on the card: an atom
    with six rows, more constraints and atoms than threads, and (1500
    atoms: 108 / 186 KB) shared memory above 48 KB; each replica's sweeps
    equal, the state within CONSTRAINT_GATE."""
    from openmmgridforce_tpu_torch import convert
    from openmmgridforce_tpu_torch.mm import constraints
    from openmmgridforce_tpu_torch.ops import cuda_constraints as cc

    idx, length, inv_mass, x = _star_chain(n_atoms, n_atoms)
    cs = convert.constraints_from_arrays(idx, length, inv_mass, dtype=dtype,
                                         device=cuda)
    threads, shared = cc.launch_plan(n_atoms, len(idx), dtype)
    assert threads == 256 and len(idx) > threads
    assert (shared > 48 * 1024) == (n_atoms == 1500)
    rng = np.random.default_rng(7)
    ref = torch.as_tensor(x + 0.002 * rng.standard_normal((5,) + x.shape),
                          dtype=dtype, device=cuda)
    state = ref + 0.003 * torch.as_tensor(rng.standard_normal(ref.shape),
                                          dtype=dtype, device=cuda)
    v = torch.as_tensor(rng.standard_normal(ref.shape), dtype=dtype,
                        device=cuda)
    for kind, a, b in (("shake", ref, state), ("rattle", ref, v)):
        for max_iter in (150, 6):
            got, sweeps = getattr(constraints, f"apply_{kind}")(
                cs, a, b, max_iter=max_iter)
            want, want_sweeps = getattr(constraints, f"{kind}_plain")(
                cs, a, b, max_iter=max_iter)
            torch.cuda.synchronize()
            assert torch.equal(sweeps, want_sweeps), (kind, max_iter)
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= CONSTRAINT_GATE[dtype], (kind, max_iter, err)


# ----------------------------------------------------------------------
# Recorded MD segments
# ----------------------------------------------------------------------

def _ladder_system(cuda, dtype, constraints=None):
    """A small ligand on fused B-spline packs of K1 grids, on the card."""
    from openmmgridforce_tpu_torch.grid import InterpolationMethod
    from openmmgridforce_tpu_torch.mm import GridBinding, system
    from openmmgridforce_tpu_torch.ops.packed import (combine_packed_grids,
                                                      pack_grid)

    lig, x, rec, rec_x = chip_smoke.synthetic_complex(5, n_ligand=23,
                                                      n_receptor=60)
    counts, origin = (40, 42, 38), tuple(x.min(0) - 1.0)
    grids = [gridgen.generate_grid(
        counts, (0.05,) * 3, origin, gt, rec_x, rec.charges, rec.sigmas,
        rec.epsilons, grid_cap=chip_smoke.GRID_CAP,
        interp_method=InterpolationMethod.BSPLINE, dtype=dtype,
        device=cuda) for gt in chip_smoke.GRID_TYPES]
    scaling = torch.as_tensor(np.stack([gridgen.auto_scaling_factors(
        gt, lig.charges, lig.sigmas, lig.epsilons)
        for gt in chip_smoke.GRID_TYPES]), dtype=dtype, device=cuda)
    binding = GridBinding(combine_packed_grids([pack_grid(g) for g in grids]),
                          scaling)
    ts = system.system_from_amber(lig, dtype=dtype, hydrogen_mass=4.0,
                                  constraints=constraints, device=cuda)
    return x, ts, binding


@pytest.mark.parametrize("constraints", [None, "HBonds"])
def test_md_runner_graph_equals_eager(cuda, constraints):
    """The recorded segment against the same blocks run eagerly, with the
    same explicit noise, on a ladder of 8 replicas: equal bit for bit in
    float32 (every force and constraint kernel adds in a fixed order on
    the card; the constrained step's SHAKE and RATTLE stop inside their
    kernel)."""
    from openmmgridforce_tpu_torch import convert
    from openmmgridforce_tpu_torch.mm import graphs, system

    x, ts, binding = _ladder_system(cuda, torch.float32, constraints)
    rng = np.random.default_rng(3)
    n_steps, R = 22, 8
    pos = x + 0.01 * rng.standard_normal((R,) + x.shape)
    noise = torch.as_tensor(rng.standard_normal((n_steps,) + pos.shape),
                            dtype=torch.float32, device=cuda)
    temps = torch.linspace(300.0, 600.0, R, device=cuda)
    run = system.make_md_runner(n_steps, 0.002 if constraints else 0.001,
                                5.0, device=cuda)
    out = {}
    before = cuda_packed_eval.packed_eval.launches
    for mode in ("graph", "eager"):
        states = convert.states_from_arrays(pos, np.zeros_like(pos), seed=0,
                                            dtype=torch.float32, device=cuda)
        if mode == "eager":
            with graphs.eager():
                out[mode] = run(states, ts, [binding], temps, noise=noise)
        else:
            out[mode] = run(states, ts, [binding], temps, noise=noise)
    torch.cuda.synchronize()
    assert cuda_packed_eval.packed_eval.launches > before
    for field in ("positions", "velocities"):
        a, b = (getattr(out[m], field) for m in ("graph", "eager"))
        assert torch.isfinite(a).all()
        assert torch.equal(a, b), (field, float((a - b).abs().max()))


@pytest.mark.parametrize("degree", chip_smoke.PACKED_EVAL_DEGREES)
def test_recorded_segment_on_k3_packs_equals_eager(cuda, degree):
    """A recorded make_md_runner segment on a K3 pack of each degree
    (seeded Chebyshev coefficients on the ladder's geometry, a back power)
    equals the same blocks run eagerly bit for bit."""
    from openmmgridforce_tpu_torch import convert
    from openmmgridforce_tpu_torch.mm import GridBinding, graphs, system

    x, ts, binding = _ladder_system(cuda, torch.float32)
    grid = binding.grid
    gen = torch.Generator(device=cuda)
    gen.manual_seed(degree)
    table = dataclasses.replace(
        grid, degree=degree, poly_basis="chebyshev",
        back_powers=(0.0, 3.0, 0.0),
        coeffs=0.1 * torch.randn((grid.coeffs.shape[0],
                                  grid.n_grids * degree ** 3),
                                 generator=gen, device=cuda))
    binding = GridBinding(table, binding.scaling)
    rng = np.random.default_rng(4)
    n_steps, R = 10, 8
    pos = x + 0.01 * rng.standard_normal((R,) + x.shape)
    noise = torch.as_tensor(rng.standard_normal((n_steps,) + pos.shape),
                            dtype=torch.float32, device=cuda)
    temps = torch.full((R,), 300.0, device=cuda)
    run = system.make_md_runner(n_steps, 0.001, 5.0, device=cuda)
    out = {}
    before = cuda_packed_eval.packed_eval.launches
    for mode in ("graph", "eager"):
        states = convert.states_from_arrays(pos, np.zeros_like(pos), seed=0,
                                            dtype=torch.float32, device=cuda)
        if mode == "eager":
            with graphs.eager():
                out[mode] = run(states, ts, [binding], temps, noise=noise)
        else:
            out[mode] = run(states, ts, [binding], temps, noise=noise)
    torch.cuda.synchronize()
    assert cuda_packed_eval.packed_eval.launches > before
    for field in ("positions", "velocities"):
        a, b = (getattr(out[m], field) for m in ("graph", "eager"))
        assert torch.isfinite(a).all()
        assert torch.equal(a, b), (field, float((a - b).abs().max()))


def test_graph_segment_matches_the_host_in_float64(cuda):
    """A constrained float64 segment recorded on the card (the sweeps
    stopped by a while node) against the plain loop on the host."""
    from openmmgridforce_tpu_torch import convert
    from openmmgridforce_tpu_torch.mm import integrators, system

    lig, x, _, _ = chip_smoke.synthetic_complex(5, n_ligand=23,
                                                n_receptor=10)
    rng = np.random.default_rng(8)
    pos = x + 0.01 * rng.standard_normal((5,) + x.shape)
    noise = rng.standard_normal((10,) + pos.shape)
    out = {}
    for dev in ("cpu", cuda):
        ts = system.system_from_amber(lig, hydrogen_mass=4.0,
                                      constraints="HBonds", device=dev)
        step = integrators.make_langevin_step(
            lambda p, ts=ts: system.energy_and_forces(ts, [], p)[1],
            ts.masses, 0.002, 5.0, 300.0, constraints=ts.constraints)
        s = integrators.run_segment(
            step, convert.states_from_arrays(pos, np.zeros_like(pos), seed=0,
                                             device=dev), 10,
            noise=torch.as_tensor(noise, device=dev))
        out[str(dev)[:4]] = s.positions.cpu().numpy()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=1e-10)


def test_sampler_trials_reuse_one_recording(cuda):
    """Sampler.run_md builds a runner per trial; the trials replay the
    recording the first one made, and exchange works on its states."""
    from openmmgridforce_tpu_torch.mm import system
    from openmmgridforce_tpu_torch.sampling import Sampler, SamplerConfig

    x, ts, binding = _ladder_system(cuda, torch.float32, "HBonds")
    system._SEGMENTS.clear()
    config = SamplerConfig(n_states=6, dt=0.002, friction=5.0,
                           md_steps_per_trial=12, seed=4)
    sampler = Sampler(ts, [binding], x, config, device=cuda)
    sampler.run_md()
    (seg,) = system._SEGMENTS.values()
    graph = seg.segment._blocks[4].graph
    assert graph is not None
    sampler.run(2, n_exchange_per_trial=3, n_gmc_per_trial=0)
    assert len(system._SEGMENTS) == 1
    assert seg.segment._blocks[4].graph is graph
    assert torch.isfinite(sampler.states.positions).all()


def test_capture_failure_raises(cuda, tmp_path):
    """A step that synchronises with the host cannot be recorded: the
    segment raises, and does not fall back to eager steps. (Run in a child
    process: PyTorch may abort the process when it destroys a graph whose
    capture failed.)"""
    import subprocess
    import sys

    script = tmp_path / "capture_fails.py"
    script.write_text(
        "import torch\n"
        "from openmmgridforce_tpu_torch.mm import graphs\n"
        "x = torch.ones(3, device='cuda')\n"
        "def advance(carry, noise):\n"
        "    return (carry[0] * float(carry[0].sum()),)\n"
        "seg = graphs.Segment(advance, (x,))\n"
        "try:\n"
        "    seg.run((x,), 8)\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__, flush=True)\n")
    root = str(__import__("pathlib").Path(chip_smoke.__file__).parent)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300, cwd=root,
                          env={**__import__("os").environ,
                               "PYTHONPATH": root})
    assert "raised" in proc.stdout, proc.stdout + proc.stderr
    assert "Error" in proc.stdout


def test_trajectory_and_respa_segments_on_the_card(cuda):
    """run_trajectory (frames copied out of the recorded blocks) and
    run_respa_segment (the slow force carried through them), constrained,
    in float64 on the card against the plain loops on the host."""
    from openmmgridforce_tpu_torch import convert
    from openmmgridforce_tpu_torch.mm import forcefield, integrators, system
    from openmmgridforce_tpu_torch.ops import pairwise

    lig, x, _, _ = chip_smoke.synthetic_complex(5, n_ligand=23,
                                                n_receptor=10)
    rng = np.random.default_rng(9)
    pos = x + 0.01 * rng.standard_normal((4,) + x.shape)
    noise = rng.standard_normal((10,) + pos.shape)
    respa_noise = rng.standard_normal((6, 4) + pos.shape)
    out = {}
    for dev in ("cpu", cuda):
        ts = system.system_from_amber(lig, hydrogen_mass=4.0,
                                      constraints="HBonds", device=dev)

        def slow(p, ts=ts):
            return pairwise.pair_energy_forces(ts.pairs, p)[1]

        def fast(p, ts=ts):
            return forcefield.bonded_energy_forces(p, ts)[1]

        def start():
            return convert.states_from_arrays(pos, np.zeros_like(pos),
                                              seed=0, device=dev)

        step = integrators.make_langevin_step(
            lambda p, ts=ts: system.energy_and_forces(ts, [], p)[1],
            ts.masses, 0.002, 5.0, 300.0, constraints=ts.constraints)
        final, traj = integrators.run_trajectory(
            step, start(), 10, 5, noise=torch.as_tensor(noise, device=dev))
        respa = integrators.make_respa_langevin_step(
            slow, fast, ts.masses, 0.002, 4, 5.0, 300.0,
            constraints=ts.constraints)
        r = integrators.run_respa_segment(
            respa, slow, start(), 6,
            noise=torch.as_tensor(respa_noise, device=dev))
        out[str(dev)[:4]] = [t.cpu().numpy() for t in
                             (final.positions, traj, r.positions,
                              r.velocities)]
    for a, b in zip(out["cpu"], out["cuda"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-9)


def test_streamed_step_without_noise_records_its_generator(cuda, tmp_path):
    """A user step that takes no noise draws from the states' generator
    inside the recorded group segment (the generator is registered with
    the recording): the run is finite and a second run from the same seed
    repeats it."""
    from openmmgridforce_tpu_torch import convert
    from openmmgridforce_tpu_torch.grid import InterpolationMethod
    from openmmgridforce_tpu_torch.io import write_grid_tiled
    from openmmgridforce_tpu_torch.io.streaming import StreamedGridEvaluator
    from openmmgridforce_tpu_torch.mm import (StreamedBatchMD, StreamSet,
                                              integrators, system)

    lig, x, _, _ = chip_smoke.synthetic_complex(3, n_ligand=10,
                                                n_receptor=10)
    x = x - x.min(0)
    g = gridgen.generate_grid((33, 33, 33), (0.125,) * 3, (-1.0,) * 3,
                              "lja", *_receptor(57, 15), grid_cap=400.0,
                              dtype=torch.float64, device="cpu")
    path = str(tmp_path / "lja.tiled")
    write_grid_tiled(path, g, tile_size=8)
    scal = [gridgen.auto_scaling_factors("lja", lig.charges, lig.sigmas,
                                         lig.epsilons)]
    ts = system.system_from_amber(lig, dtype=torch.float64, device=cuda)

    def factory(force_fn, t, base_args):
        inner = integrators.make_langevin_step(force_fn, base_args.masses,
                                               0.0005, 5.0, t)
        return lambda state: inner(state)

    runs = []
    for _ in range(2):
        ev = StreamedGridEvaluator(path, InterpolationMethod.BSPLINE,
                                   region_shape=(33, 33, 33),
                                   dtype=torch.float64, device=cuda)
        md = StreamedBatchMD(sets=[StreamSet([ev], scal)], system=ts,
                             refresh_steps=8, step_factory=factory)
        pos = np.stack([x, x + 0.3])
        states = convert.states_from_arrays(pos, np.zeros_like(pos), seed=3,
                                            device=cuda)
        runs.append(md.run(states, 300.0, 16).positions.cpu())
    assert torch.isfinite(runs[0]).all()
    assert not torch.equal(runs[0], torch.as_tensor(np.stack([x, x + 0.3])))
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=1e-12)


def _api_ligand(device, forces, method=1, constraints=None,
                integrator=None, platform=None):
    """The compat API's ligand system on ``device`` with a GridForce per
    (type, values, derivatives) of ``forces``."""
    import openmmgridforce_tpu_torch.api as gfp

    lig, x, _, _ = chip_smoke.synthetic_complex(3, n_ligand=12,
                                                n_receptor=60, gap=0.35)
    system = gfp.create_system(lig, hydrogen_mass=4.0,
                               constraints=constraints, device=device)
    for gt, counts, origin, vals, derivs in forces:
        f = gfp.GridForce()
        f.addGridCounts(*counts)
        f.addGridSpacing(0.05, 0.05, 0.05)
        f.setGridOrigin(*origin)
        f.setGridValues(vals)
        if derivs is not None:
            f.setDerivatives(derivs)
        f.setInterpolationMethod(method)
        f.setScalingProperty(gt)
        f.setAutoCalculateScalingFactors(True)
        system.addForce(f)
    ctx = gfp.Context(system, integrator or gfp.VerletIntegrator(0.001),
                      platform, device=device)
    ctx.setPositions(x)
    return ctx


def _api_grids(device, derivatives):
    """Charge/ljr/lja grids auto-generated through a receptor Context on
    ``device`` (the float64 kernels on the card)."""
    import openmmgridforce_tpu_torch.api as gfp

    _, x, rec, rx = chip_smoke.synthetic_complex(3, n_ligand=12,
                                                 n_receptor=60, gap=0.35)
    origin = tuple(x.min(0) - 0.4)
    counts = tuple(int(c) for c in
                   np.ceil((x.max(0) - x.min(0) + 0.8) / 0.05) + 1)
    system = gfp.create_system(rec, device=device)
    forces = []
    for gt in ("charge", "ljr", "lja"):
        f = gfp.GridForce()
        f.addGridCounts(*counts)
        f.addGridSpacing(0.05, 0.05, 0.05)
        f.setGridOrigin(*origin)
        f.setAutoGenerateGrid(True)
        f.setGridType(gt)
        f.setReceptorPositions(rx)
        f.setComputeDerivatives(derivatives)
        f.setScalingFactors(np.zeros(len(rx)))
        system.addForce(f)
        forces.append(f)
    gfp.Context(system, gfp.VerletIntegrator(0.001), device=device)
    return [(gt, counts, origin, np.asarray(f.getGridValues()),
             f.getDerivatives() if f.hasDerivatives() else None)
            for gt, f in zip(("charge", "ljr", "lja"), forces)]


@pytest.mark.parametrize("method", [1, 3])
@pytest.mark.parametrize("platform", [None, "Reference", "Compensated"])
def test_api_context_on_the_card_matches_the_host(cuda, method, platform):
    """Grids generated through a Context on the card (the float64 kernels)
    equal the host's; the card's getState equals a host Context's on the
    same forces: energies to 1e-10 relative, forces to 1e-9 of max|F|."""
    before = (cuda_gridgen.gridgen_values.launches,
              cuda_gridgen_derivs.gridgen_derivs.launches)
    grids = _api_grids(cuda, method == 3)
    assert (cuda_gridgen.gridgen_values.launches - before[0],
            cuda_gridgen_derivs.gridgen_derivs.launches - before[1]) == (
        (0, 3) if method == 3 else (3, 0))
    host = _api_grids("cpu", method == 3)
    for (_, _, _, v, d), (_, _, _, hv, hd) in zip(grids, host):
        np.testing.assert_allclose(v, hv, rtol=0,
                                   atol=1e-10 * np.abs(hv).max())
    on_card = _api_ligand(cuda, grids, method, platform=platform)
    on_host = _api_ligand("cpu", grids, method, platform=platform)
    for groups in (None, {0}):
        got = on_card.getState(getEnergy=True, getForces=True, groups=groups)
        want = on_host.getState(getEnergy=True, getForces=True,
                                groups=groups)
        assert got.getPotentialEnergy() == pytest.approx(
            want.getPotentialEnergy(), rel=1e-10)
        f = want.getForces()
        np.testing.assert_allclose(got.getForces(), f, rtol=0,
                                   atol=1e-9 * np.abs(f).max())


@pytest.mark.parametrize("constraints", [None, "HBonds"])
def test_api_recorded_stepping_equals_eager(cuda, constraints):
    """The Context's recorded segments (CUDA graphs) against the same
    steps as eager launches under the same noise, bit for bit; a
    setTemperature between runs reaches the recording."""
    import openmmgridforce_tpu_torch.api as gfp
    from openmmgridforce_tpu_torch.mm import graphs

    grids = _api_grids(cuda, False)
    n = 10
    noise = torch.randn((2, n) + (12, 3), generator=torch.Generator(
        device=cuda).manual_seed(4), dtype=torch.float64, device=cuda)
    out = []
    for eager in (False, True):
        ctx = _api_ligand(cuda, grids, 1, constraints,
                          gfp.LangevinIntegrator(300.0, 5.0, 0.002))
        ctx.setVelocitiesToTemperature(300.0, seed=5)
        with graphs.eager() if eager else torch.no_grad():
            ctx._step(n, noise=noise[0])
            ctx.getIntegrator().setTemperature(100.0)
            ctx._step(n, noise=noise[1])
        out.append(ctx.getState(getPositions=True, getVelocities=True))
        assert (ctx._segment is not None) and (
            eager or any(b.graph is not None
                         for b in ctx._segment._blocks.values()))
    np.testing.assert_array_equal(out[0].getPositions(),
                                  out[1].getPositions())
    np.testing.assert_array_equal(out[0].getVelocities(),
                                  out[1].getVelocities())


def test_api_dropped_context_frees_the_recording(cuda):
    """A dropped Context frees its recorded segment and its resolved
    terms at once, with no garbage collection: the forces and the
    integrator hold it weakly."""
    import gc
    import weakref

    import openmmgridforce_tpu_torch.api as gfp

    grids = _api_grids(cuda, False)
    ctx = _api_ligand(cuda, grids, 1, "HBonds",
                      gfp.LangevinIntegrator(300.0, 5.0, 0.002))
    ctx.setVelocitiesToTemperature(300.0, seed=5)
    ctx.getIntegrator().step(8)
    refs = [weakref.ref(o) for o in (ctx, ctx._segment, ctx._terms)]
    gc.disable()
    try:
        del ctx
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


def test_api_update_parameters_frees_the_recording(cuda):
    """updateParametersInContext drops the Context's recorded segment:
    the recording and the resolved terms it read are freed at once (no
    reference cycle), and the next steps record the new grids."""
    import weakref

    import openmmgridforce_tpu_torch.api as gfp

    grids = _api_grids(cuda, False)
    ctx = _api_ligand(cuda, grids, 1, "HBonds",
                      gfp.LangevinIntegrator(300.0, 5.0, 0.002))
    ctx.setVelocitiesToTemperature(300.0, seed=5)
    ctx.getIntegrator().step(8)
    seg, terms = weakref.ref(ctx._segment), weakref.ref(ctx._terms)
    force = ctx.system.getForces()[4]
    force.setGridValues(2.0 * np.asarray(force.getGridValues()))
    force.updateParametersInContext(ctx)
    assert seg() is None and terms() is None
    ctx.getIntegrator().step(8)
    assert any(b.graph is not None for b in ctx._segment._blocks.values())
    assert np.isfinite(ctx.getPositions()).all()


# ----------------------------------------------------------------------
# Scale-out: ranks on the one card
# ----------------------------------------------------------------------

_SCALEOUT_GRID = ((23, 19, 21), (0.05, 0.05, 0.05), (0.0, -0.2, 0.3))


def _scaleout_receptor():
    rng = np.random.default_rng(71)
    n = 257
    return (rng.uniform(-0.3, 1.2, (n, 3)), rng.uniform(-1, 1, n),
            rng.uniform(0.2, 0.35, n), rng.uniform(0.1, 1.0, n))


def _sharded_generation_worker(device):
    """K1 and K2 slabs of 2 ranks (gloo) on the card, gathered; and the
    launches each rank made."""
    from openmmgridforce_tpu_torch.parallel import (Mesh,
                                                    generate_grid_sharded)

    mesh = Mesh((2,), ("sp",), device)
    cuda_gridgen.gridgen_values.launches = 0
    cuda_gridgen_derivs.gridgen_derivs.launches = 0
    out = {}
    for derivs in (False, True):
        slab = generate_grid_sharded(mesh, *_SCALEOUT_GRID, "ljr",
                                     *_scaleout_receptor(), grid_cap=800.0,
                                     compute_derivatives=derivs)
        out[derivs] = slab.gather()
    return {"vals": out[False].vals, "derivs": out[True].derivs,
            "launches": (cuda_gridgen.gridgen_values.launches,
                         cuda_gridgen_derivs.gridgen_derivs.launches)}


def test_sharded_generation_on_the_card_matches_one_rank(cuda):
    """Two gloo ranks on cuda:0 each launch K1 and K2 once at their x
    offset; the gathered grids equal one rank's bit for bit."""
    from openmmgridforce_tpu_torch.parallel import distributed

    ranks = distributed.launch(_sharded_generation_worker, 2,
                               backend="gloo")
    kw = dict(grid_cap=800.0, device=cuda)
    vals = gridgen.generate_grid(*_SCALEOUT_GRID, "ljr",
                                 *_scaleout_receptor(), **kw).vals
    derivs = gridgen.generate_grid(*_SCALEOUT_GRID, "ljr",
                                   *_scaleout_receptor(),
                                   compute_derivatives=True, **kw).derivs
    for r in ranks:
        assert r["launches"] == (1, 1)
        assert torch.equal(r["vals"], vals.cpu())
        assert torch.equal(r["derivs"], derivs.cpu())


def _nccl_runner_worker(device):
    """A one-rank NCCL mesh's sharded runner: recorded (the all-reduce in
    the graph) against eager launches, under one explicit noise."""
    import torch.distributed as dist

    from openmmgridforce_tpu_torch.grid import InterpolationMethod
    from openmmgridforce_tpu_torch.mm import MDState, graphs
    from openmmgridforce_tpu_torch.mm import system as msys
    from openmmgridforce_tpu_torch.ops import packed
    from openmmgridforce_tpu_torch.parallel import (Mesh,
                                                    make_sharded_md_runner,
                                                    shard_packed_grid)

    lig, x, rec, rec_x = chip_smoke.synthetic_complex(5, n_ligand=15,
                                                      n_receptor=200)
    counts, origin = chip_smoke.grid_box(x, 0.05)
    grids = [gridgen.generate_grid(
        counts, (0.05,) * 3, origin, gt, rec_x, rec.charges, rec.sigmas,
        rec.epsilons, interp_method=InterpolationMethod.BSPLINE,
        device=device) for gt in ("charge", "ljr", "lja")]
    scaling = torch.as_tensor(np.stack([gridgen.auto_scaling_factors(
        gt, lig.charges, lig.sigmas, lig.epsilons)
        for gt in ("charge", "ljr", "lja")]), dtype=torch.float32,
        device=device)
    mesh = Mesh((1, 1), ("dp", "sp"), device)
    table = shard_packed_grid(packed.pack_grids_fused(grids, device=device),
                              mesh)
    system = msys.system_from_amber(lig, dtype=torch.float32,
                                    device=device)
    xs = torch.as_tensor(x, dtype=torch.float32, device=device)
    start = MDState(xs.expand(64, *xs.shape).clone(),
                    torch.zeros((64,) + xs.shape, device=device), None)
    noise = torch.randn((12, 64) + xs.shape, device=device,
                        generator=torch.Generator(device).manual_seed(2))
    run = make_sharded_md_runner(mesh, 12, 0.001, 5.0)
    before = graphs.RECORDINGS["count"]
    graph = run(start, system, table, scaling, 300.0, noise=noise)
    recorded = graphs.RECORDINGS["count"] - before
    with graphs.eager():
        eager = run(start, system, table, scaling, 300.0, noise=noise)
    return {"backend": dist.get_backend(), "mode": run.mode,
            "recorded": recorded, "graph": graph.positions,
            "eager": eager.positions, "start": start.positions}


def test_nccl_runner_records_its_all_reduce(cuda):
    """World size 1 on NCCL: the dp x sp runner records its segment with
    the NCCL all-reduce inside, bit for bit against eager launches."""
    from openmmgridforce_tpu_torch.parallel import distributed

    r = distributed.launch(_nccl_runner_worker, 1, backend="nccl")[0]
    assert r["backend"] == "nccl" and r["mode"] == "recorded"
    assert r["recorded"] >= 1
    assert torch.equal(r["graph"], r["eager"])
    assert float((r["graph"] - r["start"]).abs().max()) > 1e-4


def test_a_replay_runs_the_device_nodes_its_capture_counted(cuda):
    """A recorded block's device nodes, counted while it was captured,
    are the operations one traced replay of it runs; the force terms' and
    the step's spans hold every node. A constrained block (HBonds, at 2
    fs) has the split too: each step's ``omgf.constraint.shake`` and
    ``omgf.constraint.rattle`` hold the constraint kernel's one node."""
    from openmmgridforce_tpu_torch import convert
    from openmmgridforce_tpu_torch.mm import graphs, system

    terms = {"omgf.step.integrate", "omgf.force.bonded", "omgf.force.pair",
             "omgf.force.grid"}
    solver = {"omgf.constraint.shake", "omgf.constraint.rattle"}
    for constraints, dt in ((None, 0.001), ("HBonds", 0.002)):
        x, ts, binding = _ladder_system(cuda, torch.float32, constraints)
        pos = np.repeat(x[None], 8, axis=0)
        run = system.make_md_runner(graphs.BLOCK, dt, 5.0, device=cuda)
        states = convert.states_from_arrays(pos, np.zeros_like(pos), seed=0,
                                            dtype=torch.float32, device=cuda)
        run(states, ts, [binding], 300.0)
        seg = list(system._SEGMENTS.values())[-1].segment
        blk = seg._blocks[graphs.BLOCK]
        assert blk.nodes is not None, constraints
        total, spans = blk.nodes
        assert {name for name, _, n in spans if n} == (
            terms | solver if constraints else terms)
        kernels = [n for name, _, n in spans if name in solver]
        assert kernels == ([1] * 2 * graphs.BLOCK if constraints else [])
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            blk.play(seg)
            torch.cuda.synchronize()
        ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
        assert len(ops) == total, constraints
        assert f"omgf.replay.{blk.serial}" in {e.name
                                               for e in prof.events()}
        if constraints:
            assert sum("constraint_kernel" in e.name for e in ops) \
                == 2 * graphs.BLOCK
    assert graphs.while_recordings() == 0


def test_generation_on_the_card_emits_the_memory_guard_span(cuda):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gridgen.generate_grid((3, 3, 3), (0.1,) * 3, (0.0,) * 3, "ljr",
                              np.array([[0.1] * 3]), [0.0], [0.3], [1.0],
                              device=cuda)
    names = {e.name for e in prof.events()}
    assert {"omgf.gridgen", "omgf.sync.memory_guard", "omgf.sync.atoms",
            "omgf.sync.grid_geometry"} <= names


# ----------------------------------------------------------------------
# The intra-ligand force kernels (ops/cuda_ligand_forces.py)
# ----------------------------------------------------------------------

# of max |E| and of max |F|: float32 sums a few hundred terms an atom or a
# replica in another order than the twin's ATen operations (the float32
# twin itself lies 3.5e-7 / 7.9e-7 of them from float64 at this ligand);
# float64 rounds alike in every order at 1e-12
LIGAND_GATE = {torch.float32: 2e-5, torch.float64: 1e-12}
LIGAND_VARIANTS = {"bench": {}, "hbonds": {"constraints": "HBonds"},
                   "no_pairs": {"include_nonbonded": False}}


def _bench_ligand(device, dtype, variant="bench", replicas=1000):
    """The benchmark's ligand (gfbench/complex.py, structure seed 0) as a
    System on ``device`` and ``replicas`` poses near its geometry."""
    from gfbench import complex as bench_complex
    from gfbench import program
    from openmmgridforce_tpu_torch.mm import system_from_amber

    lig, _ = bench_complex.synthetic_complex(5, 47, 50, 1.3, 0.1,
                                             structure_seed=0)
    system = system_from_amber(program.topology(lig), dtype=dtype,
                               hydrogen_mass=4.0, device=device,
                               **LIGAND_VARIANTS[variant])
    rng = np.random.default_rng(17)
    x = lig.coords + 0.01 * rng.standard_normal((replicas, 47, 3))
    return system, torch.as_tensor(x, dtype=dtype, device=device)


def _ligand_kernels(system, x):
    from openmmgridforce_tpu_torch.ops import cuda_ligand_forces as lf

    energy, forces = lf.ligand_bonded(x, system)
    if system.pairs is not None:
        energy, forces = lf.ligand_pairs(system.pairs, x, energy, forces)
    return energy, forces


def _ligand_twins(system, x):
    from openmmgridforce_tpu_torch.mm.forcefield import bonded_energy_forces
    from openmmgridforce_tpu_torch.ops.pairwise import pair_energy_forces

    energy, forces = bonded_energy_forces(x, system)
    if system.pairs is not None:
        e_p, f_p = pair_energy_forces(system.pairs, x)
        energy, forces = energy + e_p, forces + f_p
    return energy, forces


def _assert_within(got, want, gate):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g).all()
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= gate, (err, gate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("variant, lead", [
    ("bench", (1000,)), ("bench", ()), ("bench", (4, 250)),
    ("hbonds", (1000,)), ("no_pairs", (1000,))])
def test_ligand_kernels_match_their_twins(cuda, variant, lead, dtype):
    """Each kernel against its plain twin on the card, at 1000 x 47 (and
    unbatched, and with two leading dimensions), energies and forces."""
    from openmmgridforce_tpu_torch.mm.forcefield import bonded_energy_forces
    from openmmgridforce_tpu_torch.ops import cuda_ligand_forces as lf

    system, x = _bench_ligand(cuda, dtype, variant)
    x = x.reshape(lead + (47, 3)) if lead else x[0]
    before = (lf.ligand_bonded.launches, lf.ligand_pairs.launches)
    _assert_within(lf.ligand_bonded(x, system),
                   bonded_energy_forces(x, system), LIGAND_GATE[dtype])
    _assert_within(_ligand_kernels(system, x), _ligand_twins(system, x),
                   LIGAND_GATE[dtype])
    torch.cuda.synchronize()
    pairs = int(system.pairs is not None)
    assert (lf.ligand_bonded.launches, lf.ligand_pairs.launches) == (
        before[0] + 2, before[1] + pairs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ligand_kernels_repeat_and_record_bit_for_bit(cuda, dtype):
    """Two launches give the same bits, and so does a recorded call."""
    system, x = _bench_ligand(cuda, dtype)
    first, second = _ligand_kernels(system, x), _ligand_kernels(system, x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        recorded = _ligand_kernels(system, x)
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, recorded):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_kernel_reads_a_table_too_large_to_stage_alike(cuda, dtype,
                                                          monkeypatch):
    """A partner table that does not fit a block's shared memory is read
    from device memory, with the same bits as the staged one."""
    from openmmgridforce_tpu_torch.ops import cuda_ligand_forces as lf

    system, x = _bench_ligand(cuda, dtype)
    bonded = lf.ligand_bonded(x, system)
    staged = lf.ligand_pairs(system.pairs, x, *bonded)
    n_entries = len(lf.pair_partners(system.pairs).entries)
    assert lf.pair_plan(47, n_entries, dtype).table_bytes > 0
    monkeypatch.setattr(lf, "MAX_SHARED", 20000)
    assert lf.pair_plan(47, n_entries, dtype).table_bytes == 0
    direct = lf.ligand_pairs(system.pairs, x, *bonded)
    torch.cuda.synchronize()
    assert torch.equal(staged[0], direct[0])
    assert torch.equal(staged[1], direct[1])


@pytest.mark.parametrize("variant", ["bench", "hbonds"])
def test_md_segment_goes_through_the_ligand_kernels(cuda, variant):
    """A recorded segment of the bench ligand (no grids) equals the same
    blocks run eagerly bit for bit, and both launch the kernels. At 1 fs:
    the poses break the HBonds constraints, and at 2 fs a replica of them
    goes non-finite on the host's twins too."""
    from openmmgridforce_tpu_torch import convert
    from openmmgridforce_tpu_torch.mm import graphs, system as mm_system
    from openmmgridforce_tpu_torch.ops import cuda_ligand_forces as lf

    ts, x = _bench_ligand(cuda, torch.float32, variant, replicas=64)
    rng = np.random.default_rng(5)
    n_steps = 8
    noise = torch.as_tensor(rng.standard_normal((n_steps,) + x.shape),
                            dtype=torch.float32, device=cuda)
    run = mm_system.make_md_runner(n_steps, 0.001, 5.0, device=cuda)
    pos = x.cpu().numpy()
    out = {}
    for mode in ("graph", "eager"):
        states = convert.states_from_arrays(pos, np.zeros_like(pos), seed=0,
                                            dtype=torch.float32, device=cuda)
        before = (lf.ligand_bonded.launches, lf.ligand_pairs.launches)
        if mode == "eager":
            with graphs.eager():
                out[mode] = run(states, ts, [], 300.0, noise=noise)
        else:
            out[mode] = run(states, ts, [], 300.0, noise=noise)
        assert lf.ligand_bonded.launches > before[0]
        assert lf.ligand_pairs.launches > before[1]
    torch.cuda.synchronize()
    for field in ("positions", "velocities"):
        a, b = (getattr(out[m], field) for m in ("graph", "eager"))
        assert torch.isfinite(a).all()
        assert torch.equal(a, b), (field, float((a - b).abs().max()))


def test_ligand_kernels_refuse_a_shape_over_their_limit(cuda):
    """Shapes whose replica does not fit a block's shared memory raise,
    naming the limit, before anything is built or launched."""
    from openmmgridforce_tpu_torch.ops import cuda_ligand_forces as lf

    system, _ = _bench_ligand(cuda, torch.float64)
    x = torch.zeros(2, 20000, 3, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match=str(lf.MAX_SHARED)):
        lf.ligand_bonded(x, system)
    n = 8000
    big = dataclasses.replace(system.pairs, **{
        k: getattr(system.pairs, k)[:1, :1].expand(n, n)
        for k in ("qq", "sigma", "epsilon", "mask")})
    e, f = x.new_zeros(2), x.new_zeros(2, n, 3)
    with pytest.raises(ValueError, match=str(lf.MAX_SHARED)):
        lf.ligand_pairs(big, x[:, :n], e, f)
    with pytest.raises(ValueError, match="float32 on"):
        lf.ligand_bonded(x.float()[:, :47], system)
