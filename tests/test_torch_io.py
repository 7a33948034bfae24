"""Port grid I/O (openmmgridforce_tpu_torch.io, ops.fd_derivs and
ops.gridgen.generate_grid_to_tiled_file) vs the JAX package, on the CPU in
float64: files that either package writes, the other reads bit for bit
(and the writers' bytes are equal); the native streamer's regions and LRU
counters; finite-difference derivatives; tiled generation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmgridforce_tpu import io as jio
from openmmgridforce_tpu.grid import Grid as JGrid
from openmmgridforce_tpu.grid import InvPowerMode as JInvPowerMode
from openmmgridforce_tpu.io.native import NativeTileStream as JStream
from openmmgridforce_tpu.ops import gridgen as jgridgen
from openmmgridforce_tpu.ops.fd_derivs import fd_derivatives27 as jfd
from openmmgridforce_tpu_torch import convert, io
from openmmgridforce_tpu_torch.grid import InvPowerMode, grid_from_numpy
from openmmgridforce_tpu_torch.io import native
from openmmgridforce_tpu_torch.io.native import NativeTileStream
from openmmgridforce_tpu_torch.ops import gridgen
from openmmgridforce_tpu_torch.ops.fd_derivs import fd_derivatives27

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def jax_native_from_port(tmp_path_factory):
    """The JAX binding loads a copy of the port's native build (the same
    source) from a directory of its own, so these tests never run g++ on
    the JAX package's ``native/`` beside the reference tests that may
    build it in another worker at the same moment."""
    import shutil

    from openmmgridforce_tpu.io import native as jnative

    if jnative._LIB is not None:
        yield
        return
    d = tmp_path_factory.mktemp("jax_native")
    shutil.copy(native.SOURCE, d / "tilestream.cpp")
    shutil.copy(native.build(), d / "libomgtilestream.so")
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_native_dir", lambda: str(d))
    jnative.load_library()
    yield
    mp.undo()


COUNTS = (9, 11, 10)
SPACING = (0.1, 0.12, 0.09)
ORIGIN = (-0.3, 0.2, 0.05)


def _grid_arrays(seed, derivs=True):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(COUNTS) * 40.0
    d = rng.standard_normal(COUNTS + (27,)) * 5.0 if derivs else None
    if d is not None:
        d[..., 0] = vals
    return vals, d


def _receptor(seed, n=23):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.3, 1.2, (n, 3)), rng.uniform(-1, 1, n),
            rng.uniform(0.2, 0.35, n), rng.uniform(0.1, 1.0, n))


@pytest.mark.parametrize("with_derivs", [False, True])
def test_omgtile_files_are_the_same_bytes(tmp_path, with_derivs):
    vals, d = _grid_arrays(1, with_derivs)
    jg = JGrid.create(vals, SPACING, ORIGIN, derivs=d, inv_power=3.0,
                      inv_power_mode=JInvPowerMode.STORED,
                      dtype=jnp.float64)
    tg = grid_from_numpy(vals, SPACING, ORIGIN, derivs=d, inv_power=3.0,
                         inv_power_mode=InvPowerMode.STORED, device="cpu")
    jio.write_grid_tiled(str(tmp_path / "j.tiled"), jg, tile_size=4)
    io.write_grid_tiled(str(tmp_path / "t.tiled"), tg, tile_size=4)
    assert ((tmp_path / "j.tiled").read_bytes()
            == (tmp_path / "t.tiled").read_bytes())
    # each package reads the other's file bit for bit
    with io.TiledGridReader(str(tmp_path / "j.tiled")) as r:
        got_v, got_d = r.read_full()
        meta = (r.counts, r.spacing, r.origin, r.tile_size,
                r.has_derivatives, r.inv_power, r.inv_power_mode)
    with jio.TiledGridReader(str(tmp_path / "t.tiled")) as r:
        ref_v, ref_d = r.read_full()
        ref_meta = (r.counts, r.spacing, r.origin, r.tile_size,
                    r.has_derivatives, r.inv_power, r.inv_power_mode)
    assert meta == ref_meta
    np.testing.assert_array_equal(got_v, ref_v)
    np.testing.assert_array_equal(got_v, vals.astype(np.float32))
    if with_derivs:
        np.testing.assert_array_equal(got_d, ref_d)
    else:
        assert got_d is None and ref_d is None


def test_omgtile_tiles_in_any_order(tmp_path):
    """The writer takes tiles in any order; the index puts them back."""
    vals, _ = _grid_arrays(2, False)
    path = str(tmp_path / "shuffled.tiled")
    w = io.TiledGridWriter(path, COUNTS, SPACING, ORIGIN, tile_size=4)
    tiles = [(tx, ty, tz) for tx in range(w.ntx) for ty in range(w.nty)
             for tz in range(w.ntz)]
    for n in np.random.default_rng(0).permutation(len(tiles)):
        tx, ty, tz = tiles[n]
        x0, y0, z0, x1, y1, z1 = io.omgtile.tile_range(COUNTS, 4, tx, ty,
                                                        tz)
        w.write_tile(tx, ty, tz, vals[x0:x1, y0:y1, z0:z1])
    w.close()
    with jio.TiledGridReader(path) as r:
        np.testing.assert_array_equal(r.read_full()[0],
                                      vals.astype(np.float32))


@pytest.mark.parametrize("kind", ["values", "derivs", "griddata",
                                  "griddata_derivs"])
def test_v3_files_are_the_same_bytes(tmp_path, kind):
    vals, d = _grid_arrays(3, "derivs" in kind)
    dfile = None if d is None else np.moveaxis(d, -1, 0)
    if kind.startswith("griddata"):
        args = (COUNTS, SPACING, ORIGIN, vals, dfile)
        kw = dict(inv_power=2.0, inv_power_mode=1)
        jio.save_v3_griddata(str(tmp_path / "j.grid"), *args, **kw)
        io.save_v3_griddata(str(tmp_path / "t.grid"), *args, **kw)
    else:
        args = (COUNTS, SPACING, ORIGIN, vals, dfile)
        kw = dict(grid_type="ljr", inv_power=2.0, inv_power_mode=2)
        jio.save_v3(str(tmp_path / "j.grid"), *args, **kw)
        io.save_v3(str(tmp_path / "t.grid"), *args, **kw)
    assert ((tmp_path / "j.grid").read_bytes()
            == (tmp_path / "t.grid").read_bytes())
    got = io.load_v3(str(tmp_path / "j.grid"))
    ref = jio.load_v3(str(tmp_path / "t.grid"))
    for f in ("counts", "spacing", "origin", "grid_type", "inv_power",
              "inv_power_mode"):
        assert getattr(got, f) == getattr(ref, f), f
    np.testing.assert_array_equal(got.vals, ref.vals)
    np.testing.assert_array_equal(got.vals, vals)
    if d is None:
        assert got.derivs is None and ref.derivs is None
    else:
        np.testing.assert_array_equal(got.derivs, ref.derivs)


def test_netcdf_dx_and_conversion_cross_read(tmp_path):
    vals, _ = _grid_arrays(4, False)
    flat = vals.reshape(-1)
    jio.write_netcdf(str(tmp_path / "j.nc"), COUNTS, SPACING, flat, ORIGIN)
    io.write_netcdf(str(tmp_path / "t.nc"), COUNTS, SPACING, flat, ORIGIN)
    assert ((tmp_path / "j.nc").read_bytes()
            == (tmp_path / "t.nc").read_bytes())
    got, ref = (io.read_netcdf(str(tmp_path / "j.nc")),
                jio.read_netcdf(str(tmp_path / "t.nc")))
    assert (got["counts"], got["spacing"], got["origin"]) == (
        ref["counts"], ref["spacing"], ref["origin"])
    np.testing.assert_array_equal(got["vals"], ref["vals"])
    np.testing.assert_array_equal(got["vals"], flat)

    for name in ("j.dx", "t.dx.gz"):
        pkg = jio if name.startswith("j") else io
        pkg.write_dx(str(tmp_path / name), COUNTS, SPACING, flat, ORIGIN)
    assert (tmp_path / "j.dx").read_text() == __import__("gzip").open(
        tmp_path / "t.dx.gz", "rt").read()
    got = io.read_dx(str(tmp_path / "j.dx"), to_nm=True)
    ref = jio.read_dx(str(tmp_path / "t.dx.gz"), to_nm=True)
    for key in ("origin", "spacing", "counts", "vals"):
        np.testing.assert_array_equal(got[key], ref[key])

    io.nc_to_v3(str(tmp_path / "j.nc"), str(tmp_path / "t.grid"))
    jio.nc_to_v3(str(tmp_path / "j.nc"), str(tmp_path / "j.grid"))
    assert ((tmp_path / "t.grid").read_bytes()
            == (tmp_path / "j.grid").read_bytes())


@pytest.mark.parametrize("fmt", ["v3", "omgtile"])
def test_grid_from_file_matches_jax(tmp_path, fmt):
    vals, d = _grid_arrays(5)
    path = str(tmp_path / "g")
    if fmt == "v3":
        io.save_v3(path, COUNTS, SPACING, ORIGIN, vals,
                   np.moveaxis(d, -1, 0), grid_type="lja", inv_power=4.0,
                   inv_power_mode=2)
    else:
        io.write_grid_tiled(path, grid_from_numpy(
            vals, SPACING, ORIGIN, derivs=d, inv_power=4.0,
            inv_power_mode=2, device="cpu"), tile_size=4)
    ref = jio.grid_from_file(path, interp_method=3, grid_cap=900.0)
    got = io.grid_from_file(path, device="cpu", interp_method=3,
                            grid_cap=900.0)
    assert got.vals.device.type == "cpu"
    assert got.vals.dtype == (torch.float64 if fmt == "v3"
                              else torch.float32)
    # the JAX grid carried across by convert equals the port's own read
    fields = ("counts", "interp_method", "inv_power_mode", "inv_power",
              "grid_cap", "oob_k", "grid_type")
    carried = convert.grid_from_jax(
        ref.vals, ref.spacing, ref.origin, derivs=ref.derivs, device="cpu",
        **{f: getattr(ref, f) for f in fields if f != "counts"})
    for grid in (got, carried):
        for f in ("vals", "derivs", "spacing", "origin"):
            np.testing.assert_array_equal(getattr(grid, f).numpy(),
                                          np.asarray(getattr(ref, f)))
        for f in fields:
            assert getattr(grid, f) == getattr(ref, f), f


def test_native_builds_into_the_package(tmp_path):
    """The port's copy of the streamer is built from native/tilestream.cpp
    into _build/, never under native/."""
    lib = native.build()
    assert lib.parent.name == "_build" and lib.exists()
    assert lib.parent.parent.name == "openmmgridforce_tpu_torch"


@pytest.fixture
def tiled_file(tmp_path):
    vals, d = _grid_arrays(6)
    path = str(tmp_path / "grid.tiled")
    io.write_grid_tiled(path, grid_from_numpy(vals, SPACING, ORIGIN,
                                              derivs=d, device="cpu"),
                        tile_size=4)
    return path


def test_native_regions_and_lru_match_jax(tiled_file):
    """Clamped regions equal read_full slices (zero past the grid, as the
    native streamer fills them), and both bindings count the same hits,
    misses and evictions on one access sequence."""
    with io.TiledGridReader(tiled_file) as r:
        full_v, full_d = r.read_full()
    tile_bytes = 4 ** 3 * 28 * 4
    seq = [((0, 0, 0), (5, 6, 7)), ((3, 2, 1), (6, 6, 6)),
           ((0, 0, 0), (5, 6, 7)), ((6, 8, 7), (5, 5, 5)),
           ((1, 1, 1), (8, 9, 8))]
    with NativeTileStream(tiled_file, budget_bytes=5 * tile_bytes) as ts, \
            JStream(tiled_file, budget_bytes=5 * tile_bytes) as js:
        assert (ts.counts, ts.spacing, ts.origin, ts.tile_size,
                ts.has_derivatives) == (js.counts, js.spacing, js.origin,
                                        js.tile_size, js.has_derivatives)
        for start, shape in seq:
            v, d = ts.read_region(start, shape, with_derivatives=True)
            jv, jd = js.read_region(start, shape, with_derivatives=True)
            np.testing.assert_array_equal(v, jv)
            np.testing.assert_array_equal(d, jd)
            stop = [min(s + n, c) for s, n, c in zip(start, shape, COUNTS)]
            sl = tuple(slice(s, e) for s, e in zip(start, stop))
            inner = tuple(slice(0, e - s) for s, e in zip(start, stop))
            np.testing.assert_array_equal(v[inner], full_v[sl])
            np.testing.assert_array_equal(d[(slice(None),) + inner],
                                          full_d[(slice(None),) + sl])
            assert vars(ts.cache_stats()) == vars(js.cache_stats())
        tv, td = ts.read_tile(1, 2, 2)
        jv, jd = js.read_tile(1, 2, 2)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(td, jd)
        st = ts.cache_stats()
        assert st.evictions > 0 and st.hits > 0
        assert st.used_bytes <= 5 * tile_bytes


@pytest.mark.parametrize("grid_cap", [None, 30.0])
def test_fd_derivatives27_matches_jax(grid_cap):
    """The same stencils on tensors: equal to JAX within 1e-12 of each
    slot's largest value (the gates of tests/test_fd_derivs.py are 1e-8
    against the exact field)."""
    vals, _ = _grid_arrays(7, False)
    vals[4, 5, 5] = 45.0
    ref = np.asarray(jfd(vals, SPACING, grid_cap))
    got = fd_derivatives27(torch.as_tensor(vals), SPACING, grid_cap).numpy()
    scale = np.abs(ref).reshape(-1, 27).max(0)
    assert (np.abs(got - ref).reshape(-1, 27).max(0)
            <= 1e-12 * scale).all()


def _read_full(path):
    with io.TiledGridReader(path) as r:
        return r.read_full()


@pytest.mark.parametrize("grid_type,mode,derivs", [
    ("charge", "NONE", False), ("ljr", "NONE", False),
    ("lja", "NONE", False), ("ljr", "STORED", False),
    ("ljr", "RUNTIME", False), ("charge", "NONE", True),
    ("ljr", "STORED", True)])
def test_tiled_generation_matches_jax(tmp_path, grid_type, mode, derivs):
    """Tiles of 4 over a 9 x 11 x 10 box (8 x 8 x 8 with derivatives, one
    tile shape for JAX to compile): the port (plain twins, float64)
    against the JAX jnp route (float64); both store float32. Values agree
    to 1e-6 of the largest (a float32 rounding of float64 sums that agree
    to 1e-12), derivatives to 1e-6 of each slot's largest (the float64
    derivative grids of the two packages agree to 1e-6, ROADMAP Queue
    C)."""
    pos, q, sig, eps = _receptor(8)
    counts = (8, 8, 8) if derivs else COUNTS
    n_tiles = 8 if derivs else 27
    kw = dict(tile_size=4, compute_derivatives=derivs, grid_cap=800.0,
              inv_power=3.0 if mode != "NONE" else 0.0)
    ticks = []
    jgridgen.generate_grid_to_tiled_file(
        str(tmp_path / "j.tiled"), counts, SPACING, ORIGIN, grid_type, pos,
        q, sig, eps, inv_power_mode=JInvPowerMode[mode], backend="jnp",
        dtype=jnp.float64, **kw)
    gridgen.generate_grid_to_tiled_file(
        str(tmp_path / "t.tiled"), counts, SPACING, ORIGIN, grid_type, pos,
        q, sig, eps, inv_power_mode=InvPowerMode[mode], dtype=torch.float64,
        device="cpu", progress=lambda d, t: ticks.append((d, t)),
        slab_budget_bytes=1 << 16, **kw)
    assert ticks[-1] == (n_tiles, n_tiles) and len(ticks) == n_tiles
    got_v, got_d = _read_full(str(tmp_path / "t.tiled"))
    ref_v, ref_d = _read_full(str(tmp_path / "j.tiled"))
    assert np.abs(got_v - ref_v).max() <= 1e-6 * np.abs(ref_v).max()
    if derivs:
        scale = np.abs(ref_d).reshape(27, -1).max(1)
        assert (np.abs(got_d - ref_d).reshape(27, -1).max(1)
                <= 1e-6 * scale).all()
    # the file holds exactly the in-memory grid (global index per slab)
    mem = gridgen.generate_grid(
        counts, SPACING, ORIGIN, grid_type, pos, q, sig, eps,
        compute_derivatives=derivs, grid_cap=800.0,
        inv_power=kw["inv_power"], inv_power_mode=InvPowerMode[mode],
        dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(got_v, mem.vals.numpy().astype(
        np.float32))
    if derivs:
        np.testing.assert_array_equal(got_d, np.moveaxis(
            mem.derivs.numpy().astype(np.float32), -1, 0))


def _load(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _amber_files(tmp_path, seed=8):
    import chip_smoke
    from test_torch_mm import write_inpcrd, write_prmtop

    lig, x, rec, rec_x = chip_smoke.synthetic_complex(
        seed, n_ligand=12, n_receptor=80, gap=0.5)
    for name, top, crd in (("ligand", lig, x), ("receptor", rec, rec_x)):
        write_prmtop(tmp_path / f"{name}.prmtop", top)
        write_inpcrd(tmp_path / f"{name}.trans.inpcrd", crd)
    return lig, x, rec, rec_x


def test_bpmf_example_reads_grid_files(tmp_path):
    """examples/bpmf_sampler_torch.py without --generate-grids reads the
    NetCDF (Angstrom, kcal/mol) and V3 files that input.json names, one
    B-spline pack each, as the JAX example's get_grid_binding builds them
    (float32 packs of the same values within 1e-6 of their largest
    coefficient), and runs the ladder on them."""
    import json

    from openmmgridforce_tpu_torch.units import ANGSTROM_TO_NM, KCAL_TO_KJ

    lig, x, rec, rec_x = _amber_files(tmp_path)
    lo = x.min(0) - 0.5
    counts = tuple(int(c) + 1 for c in np.ceil((x.max(0) + 0.5 - lo) / 0.1))
    files, convs = {}, [KCAL_TO_KJ, np.sqrt(KCAL_TO_KJ) * 1e6,
                        np.sqrt(KCAL_TO_KJ) * 1e3]
    for key, gt, conv in zip(("direct_elec", "LJr", "LJa"),
                             ("charge", "ljr", "lja"), convs):
        g = gridgen.generate_grid(counts, (0.1,) * 3, tuple(lo), gt, rec_x,
                                  rec.charges, rec.sigmas, rec.epsilons,
                                  dtype=torch.float64, device="cpu")
        vals = g.vals.numpy() / conv
        if gt == "charge":
            files[key] = str(tmp_path / "elec.nc")
            io.write_netcdf(files[key], counts,
                            [0.1 / ANGSTROM_TO_NM] * 3, vals,
                            tuple(lo / ANGSTROM_TO_NM))
        else:
            files[key] = str(tmp_path / f"{gt}.grid")
            io.save_v3(files[key], counts, (0.1,) * 3, tuple(lo), vals)
    cfg = {"run_job": "CD", "nstate": 2, "ntrial_repX": 1, "ntrial_gMC": 1,
           "nstep_MD": 3, "nstep_equil": 4,
           "CD": {"T_HIGH": 600.0, "T_SIMMIN": 300.0, "H_mass": 4.0,
                  "delta_t": 1.0},
           "dir": {"ligand_prmtop": str(tmp_path / "ligand.prmtop"),
                   "ligand_inpcrd": str(tmp_path / "ligand.trans.inpcrd")},
           "grids": files}
    (tmp_path / "input.json").write_text(json.dumps(cfg))
    sampler = _load("bpmf_sampler_torch").main(
        ["-i", str(tmp_path / "input.json"), "--device", "cpu",
         "--n-trials", "1", "--work-dir", str(tmp_path / "out"),
         "--friction", "5"])
    assert len(sampler.grids) == 3
    assert torch.isfinite(sampler.states.positions).all()
    jex = _load("bpmf_sampler")
    for binding, key, conv in zip(sampler.grids, ("direct_elec", "LJr",
                                                  "LJa"), convs):
        ref = jex.get_grid_binding(files[key], conv, np.ones(12), 1,
                                   jnp.float32)
        a, b = binding.grid.coeffs.numpy(), np.asarray(ref.grid.coeffs)
        b = b[:, :a.shape[1]]
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
        np.testing.assert_allclose(binding.grid.origin.numpy(),
                                   np.asarray(ref.grid.origin), rtol=1e-6)


def test_docking_screen_example_runs_on_cpu(tmp_path, capsys):
    """examples/docking_screen_torch.py --device cpu --streamed: the
    in-memory screen and the out-of-core one agree on the grid energy of
    in-box poses (1e-4 of the larger of |E| and 1 kJ/mol, the JAX
    example's reading of the same comparison)."""
    _amber_files(tmp_path, seed=9)
    out = _load("docking_screen_torch").main(
        ["--poses", "24", "--spacing", "0.1", "--data", str(tmp_path),
         "--streamed", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "scored 24 poses" in text and "streamed (out-of-core)" in text
    assert np.isfinite(out["energies"]).all()
    inb = out["in_box"]
    assert inb.sum() > 0
    rel = (np.abs(out["streamed"] - out["in_memory"])[inb]
           / np.maximum(np.abs(out["in_memory"][inb]), 1.0))
    assert rel.max() < 1e-4
