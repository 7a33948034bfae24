"""Checks of the port that need an NVIDIA GPU (marker ``cuda``; skipped
without one). This file imports no JAX, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from openmmgridforce_tpu_torch.ops import (cuda_gridgen, cuda_gridgen_derivs,
                                           gridgen)

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
    counts, on two calls with other inputs (the card replays the graphs
    the first call recorded)."""
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
    float32 (every force and constraint scatter adds in a fixed order on
    the card, ``ops/scatter.py``; the constrained step stops its sweeps in
    a WHILE node)."""
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
    for mode in ("graph", "eager"):
        states = convert.states_from_arrays(pos, np.zeros_like(pos), seed=0,
                                            dtype=torch.float32, device=cuda)
        if mode == "eager":
            with graphs.eager():
                out[mode] = run(states, ts, [binding], temps, noise=noise)
        else:
            out[mode] = run(states, ts, [binding], temps, noise=noise)
    torch.cuda.synchronize()
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
