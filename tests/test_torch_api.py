"""Port compat API (openmmgridforce_tpu_torch.api) vs the JAX package's
``openmmgridforce_tpu.api`` on the CPU, in float64.

The same inputs, made from a seed with numpy, go through both packages:
the public surface, the GridData/GridForce setters and getters, V3 and
DX files, grid auto-generation through a Context (values to 1e-12 of the
grid's max, derivatives to 1e-6 of each slot's max: both take tanh from
their own libm), auto scaling under both conventions, ``getState``
energies (1e-10 relative) and forces (1e-9 of max|F|) per force group
(``test_torch_api_platforms.py`` runs them for the four interpolation
methods on the four platforms), the reference platform's quirks Q1/Q4/Q5
and the common platform's Q6, the atom selections and per-group/per-atom
energy queries, parameter updates, and IsolatedNonbondedForce. The ligand
and the receptor are ``chip_smoke.synthetic_complex``'s (the JAX tests'
AMBER fixtures are absent). Stepping and minimisation are in
``test_torch_api_md.py``, streamed (tiled-file) Contexts in
``test_torch_api_streamed.py``; these files share this one's helpers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import openmmgridforce_tpu.api as jgfp
import openmmgridforce_tpu_torch.api as tgfp
from openmmgridforce_tpu.io import gridio as jgridio
from openmmgridforce_tpu.mm.amber import AmberTopology as JTopology
from openmmgridforce_tpu_torch.grid import grid_from_numpy
from openmmgridforce_tpu_torch.io import gridio

torch.set_num_threads(1)

GRID_TYPES = ("charge", "ljr", "lja")
N_LIGAND, N_RECEPTOR = 10, 40
SPACING = 0.1
E_RTOL, F_RTOL = 1e-10, 1e-9


def jax_topology(top):
    return JTopology(**dataclasses.asdict(top))


@pytest.fixture(scope="module")
def world():
    lig, x, rec, rx = chip_smoke.synthetic_complex(
        3, n_ligand=N_LIGAND, n_receptor=N_RECEPTOR, gap=0.35)
    lo = x.min(0) - 0.4
    counts = (int(np.ceil((x.max(0) - lo + 0.4).max() / SPACING)) + 1,) * 3
    return dict(lig=lig, x=x, rec=rec, rx=rx, origin=tuple(lo),
                counts=counts)


def _kw(g):
    return {} if g is jgfp else {"device": "cpu"}


def _top(g, top):
    return jax_topology(top) if g is jgfp else top


def _geometry(f, w, spacing=SPACING):
    f.addGridCounts(*w["counts"])
    f.addGridSpacing(spacing, spacing, spacing)
    f.setGridOrigin(*w["origin"])


def _generate(g, w, derivatives, platform):
    """Three GridForces auto-generated on the receptor system through a
    Context of ``platform``: [(values, derivatives or None)] by type."""
    system = g.create_system(_top(g, w["rec"]), **_kw(g))
    forces = []
    for gt in GRID_TYPES:
        f = g.GridForce()
        _geometry(f, w)
        f.setAutoGenerateGrid(True)
        f.setGridType(gt)
        f.setReceptorAtoms(list(range(N_RECEPTOR)))
        f.setReceptorPositionsFromLists(w["rx"])
        f.setComputeDerivatives(derivatives)
        f.setScalingFactors(np.zeros(N_RECEPTOR))
        system.addForce(f)
        forces.append(f)
    g.Context(system, g.VerletIntegrator(0.001),
              g.Platform.getPlatformByName(platform), **_kw(g))
    return [(np.asarray(f.getGridValues()),
             f.getDerivatives() if f.hasDerivatives() else None)
            for f in forces]


_GENERATED = {}


def generated(g, w, derivatives, platform):
    """Each package's own generated grids, once per (package,
    derivatives, LJ convention: the reference platform's is Q3's)."""
    key = (g.__name__, derivatives, platform == "Reference")
    if key not in _GENERATED:
        _GENERATED[key] = _generate(g, w, derivatives, platform)
    return _GENERATED[key]


def ligand_context(g, w, method, platform, configure=None, integrator=None,
                   **system_kw):
    """The ligand system (``create_system``'s ``system_kw``) with the
    three grids of ``method`` (each in its own force group 0/1/2; the
    system's terms in group 31) on ``platform``, at the ligand's pose."""
    system = g.create_system(_top(g, w["lig"]), **system_kw, **_kw(g))
    for f in system.getForces():
        f.setForceGroup(31)
    grids = generated(g, w, method >= 2, platform)
    for i, (gt, (vals, derivs)) in enumerate(zip(GRID_TYPES, grids)):
        f = g.GridForce()
        _geometry(f, w)
        f.setGridValues(vals)
        if derivs is not None:
            f.setDerivatives(derivs)
        f.setInterpolationMethod(method)
        f.setScalingProperty(gt)
        f.setAutoCalculateScalingFactors(True)
        f.setForceGroup(i)
        if configure is not None:
            configure(i, f)
        system.addForce(f)
    ctx = g.Context(system, integrator or g.VerletIntegrator(0.001),
                    g.Platform.getPlatformByName(platform), **_kw(g))
    ctx.setPositions(w["x"])
    return ctx


def assert_states_match(jctx, tctx, groups=(None, {0}, {1}, {2}, {31})):
    for grp in groups:
        js = jctx.getState(getEnergy=True, getForces=True, groups=grp)
        ts = tctx.getState(getEnergy=True, getForces=True, groups=grp)
        je, te = js.getPotentialEnergy(), ts.getPotentialEnergy()
        assert te == pytest.approx(je, rel=E_RTOL, abs=1e-12), grp
        jf = np.asarray(js.getForces())
        np.testing.assert_allclose(ts.getForces(), jf, rtol=0,
                                   atol=F_RTOL * np.abs(jf).max() + 1e-300,
                                   err_msg=str(grp))


# ----------------------------------------------------------------------
# Surface, setters and files
# ----------------------------------------------------------------------

def _public(module):
    return {n for n in dir(module) if not n.startswith("_")} - {
        "context", "gridforce", "isolated", "lbfgs", "annotations"}


def test_public_names_match_jax():
    assert _public(tgfp) == _public(jgfp)


@pytest.mark.parametrize("name", [
    "GridData", "GridForce", "IsolatedNonbondedForce", "ParticleGroup",
    "Context", "Simulation", "State", "Platform", "ApiSystem",
    "VerletIntegrator", "LangevinIntegrator", "LangevinMiddleIntegrator",
    "NonbondedForce", "HarmonicBondForce"])
def test_class_surfaces_match_jax(name):
    """Every public method and attribute of each API class, as in JAX."""
    def public(cls):
        return {n for n in dir(cls) if not n.startswith("_")}

    assert public(getattr(tgfp, name)) == public(getattr(jgfp, name))


def _drive_setters(g):
    """Every GridData/GridForce setter, then every getter."""
    rng = np.random.default_rng(4)
    gd = g.GridData(3, 4, 5, 0.1, 0.2, 0.3)
    gd.setOrigin(1.0, 2.0, 3.0)
    gd.setValues(rng.standard_normal(60))
    gd.setDerivatives(rng.standard_normal(27 * 60))
    gd.setGridType("ljr")
    f = g.GridForce()
    f.addGridCounts(2, 3, 2)
    f.addGridSpacing(0.1, 0.1, 0.2)
    f.setGridOrigin(-1.0, 0.5, 0.25)
    for v in rng.standard_normal(12):
        f.addGridValue(v)
    f.addScalingFactor(0.5)
    f.setScalingFactors([1.0, 2.0, 3.0])
    f.setScalingFactor(1, 4.0)
    f.setAutoCalculateScalingFactors(True)
    f.setScalingProperty("lja")
    f.setInvPowerMode(g.InvPowerMode_RUNTIME, 3.0)
    f.setGridCap(123.0)
    f.setOutOfBoundsRestraint(55.0)
    f.setInterpolationMethod(2)
    f.setAutoGenerateGrid(True)
    f.setGridType("charge")
    f.setComputeDerivatives(True)
    f.setDerivatives(rng.standard_normal(27 * 12))
    f.setParticles([0, 2])
    f.setReceptorAtoms([3, 4])
    f.setLigandAtoms([0, 1, 2])
    f.setReceptorPositionsFromArrays([0.1, 0.2], [0.3, 0.4], [0.5, 0.6])
    f.addParticleGroup("a", [0, 1], [1.0, 2.0])
    f.addParticleGroup("b", [2])
    f.setTiledMode(True, tile_size=16, memory_budget_mb=64)
    f.setTiledOOBConvention("cuda-tiled")
    f.setStreamRegionShape(8, 9, 10)
    f.setTiledOutputFile("out.tiled", 8)
    f.setTiledInputFile("in.tiled")
    f.setForceGroup(7)
    f.applyInvPowerTransformation()
    f2 = g.GridForce(gd)
    f2.addGridValue(9.0)
    iso = g.IsolatedNonbondedForce()
    iso.setNumAtoms(3)
    iso.setParticles([4, 5, 6])
    iso.setAtomParameters(1, 0.2, 0.3, 0.4)
    iso.addExclusion(0, 2)
    iso.addException(0, 1, 0.1, 0.2, 0.3)
    out = [gd.getNx(), gd.getNy(), gd.getNz(), gd.getCounts(), gd.getDx(),
           gd.getDy(), gd.getDz(), gd.getSpacing(), gd.getOrigin(),
           gd.getValues(), gd.getDerivatives(), gd.hasDerivatives(),
           gd.getGridType(), gd.getInvPower()]
    out += [f.getGridOrigin(), f.getGridValues(), f.getNumGridValues(),
            f.getScalingFactors(), f.getNumScalingFactors(),
            f.getAutoCalculateScalingFactors(), f.getScalingProperty(),
            f.getInvPowerMode(), f.getInvPower(), f.getGridCap(),
            f.getOutOfBoundsRestraint(), f.getInterpolationMethod(),
            f.getAutoGenerateGrid(), f.getGridType(),
            f.getComputeDerivatives(), f.hasDerivatives(),
            f.getDerivatives(), f.getParticles(), f.getReceptorAtoms(),
            f.getLigandAtoms(), f.getReceptorPositions(),
            f.getNumParticleGroups(),
            dataclasses.astuple(f.getParticleGroup(1)),
            dataclasses.astuple(f.getParticleGroupByName("a")),
            f.getParticleGroupByName("none"), f.getTiledMode(),
            f.getTileSize(), f.getMemoryBudgetMB(),
            f.getTiledOOBConvention(), f.getStreamRegionShape(),
            f.getTiledOutputFile(), f.getTiledOutputTileSize(),
            f.getTiledInputFile(), f.getForceGroup(), f.getGridParameters(),
            f.getParticleGroupEnergies(), f.getParticleAtomEnergies(),
            f2.getGridValues(), f2.getGridData().getValues(),
            f2.getGridParameters()[:2]]
    f.removeParticleGroup(0)
    out.append(f.getParticleGroup(0).name)
    f.clearParticleGroups()
    out.append(f.getNumParticleGroups())
    out += [iso.getNumAtoms(), iso.getParticles(), iso.getAtomParameters(1),
            iso.getNumExclusions(), iso.getExclusion(0),
            iso.getNumExceptions(), iso.getExceptionParameters(0)]
    out += [g.castToGridForce(f) is f, g.castToGridForce(iso),
            g.clearGridCache()]
    return out


def test_setters_and_getters_match_jax():
    got, want = _drive_setters(tgfp), _drive_setters(jgfp)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(b, np.ndarray) or (isinstance(b, (list, tuple)) and b
                                         and isinstance(b[0], list)):
            np.testing.assert_equal(np.asarray(a, dtype=object),
                                    np.asarray(b, dtype=object),
                                    err_msg=str(i))
        else:
            assert a == b, (i, a, b)
    for g in (tgfp, jgfp):
        f = g.GridForce()
        with pytest.raises(ValueError, match="Invalid scaling property"):
            f.setScalingProperty("bogus")
        with pytest.raises(ValueError, match="Invalid grid type"):
            f.setGridType("bogus")
        with pytest.raises(ValueError, match="force group"):
            f.setForceGroup(32)
        with pytest.raises(ValueError, match="interpolation method"):
            f.setInterpolationMethod(4)
        f.addParticleGroup("a", [0])
        with pytest.raises(ValueError, match="already exists"):
            f.addParticleGroup("a", [1])


def _share(g):
    """tests/test_migration_surface.py's GridData sharing sequence."""
    gd = g.GridData(3, 3, 3, 0.1, 0.1, 0.1)
    gd.setValues(np.arange(27.0))
    g1, g2 = g.GridForce(gd), g.GridForce()
    g2.setGridData(gd)
    out = [g1.getGridData() is g2.getGridData(),
           np.shares_memory(g1._values_flat(), gd.getValues())]
    gd.setValues(np.arange(27.0) * 2.0)
    out.append(g1.getGridValues())
    g1.setGridValues(np.arange(27.0) + 5.0)
    out += [gd.getValues(), g2.getGridValues(), g1.hasDerivatives()]
    g1.setDerivatives(np.arange(27.0 * 27))
    out += [gd.hasDerivatives(), g2.getDerivatives()]
    g1.clearGridData()
    out.append(gd.getValues())
    g2.addGridValue(1.5)
    out.append(g1.getNumGridValues())
    return out


def test_griddata_shared_between_forces_as_jax():
    """One GridData behind several forces: aliased, read and written
    through, as in JAX (the reference's shared_ptr<GridData>)."""
    got, want = _share(tgfp), _share(jgfp)
    assert got[:2] == want[:2] == [True, True]
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)


def test_griddata_force_drives_the_context_as_flat_values(world):
    """A force on a GridData and one on flat setters give one energy."""
    vals, _ = generated(tgfp, world, False, "CUDA")[0]
    gd = tgfp.GridData(*world["counts"], *(SPACING,) * 3)
    gd.setOrigin(*world["origin"])
    gd.setValues(vals)
    flat = ligand_context(tgfp, world, 1, "CUDA")
    shared = ligand_context(
        tgfp, world, 1, "CUDA",
        configure=lambda i, f: f.setGridData(gd) if i == 0 else None)
    assert (shared.getState(getEnergy=True, groups={0}).getPotentialEnergy()
            == flat.getState(getEnergy=True, groups={0})
            .getPotentialEnergy())


def _file_force(g, rng_seed, derivs):
    rng = np.random.default_rng(rng_seed)
    f = g.GridForce()
    f.addGridCounts(4, 3, 5)
    f.addGridSpacing(0.1, 0.125, 0.2)
    f.setGridOrigin(0.5, -0.25, 1.0)
    f.setGridType("ljr")
    f.setInvPowerMode(g.InvPowerMode_STORED, 2.0)
    f.setGridValues(rng.standard_normal(60))
    if derivs:
        f.setDerivatives(rng.standard_normal(27 * 60))
    return f


@pytest.mark.parametrize("derivs", [False, True])
def test_v3_files_cross_load(tmp_path, derivs):
    """A V3 file saved by one package (GridForce and GridData) loads in
    the other with the same values and metadata."""
    for src, dst in ((jgfp, tgfp), (tgfp, jgfp)):
        f = _file_force(src, 8, derivs)
        path = str(tmp_path / f"{src.__name__}.grid")
        f.saveToFile(path)
        g, h = dst.GridForce(), src.GridForce()
        g.loadFromFile(path)
        h.loadFromFile(path)
        assert g.getGridParameters()[:3] == h.getGridParameters()[:3]
        assert g.getGridParameters()[:2] == f.getGridParameters()[:2]
        assert g.getGridOrigin() == f.getGridOrigin()
        assert (g.getGridType(), g.getInvPowerMode(), g.getInvPower()) == \
            ("ljr", 2, 2.0)
        np.testing.assert_array_equal(g.getDerivatives(),
                                      f.getDerivatives())
        if not derivs:
            np.testing.assert_array_equal(g.getGridValues(),
                                          f.getGridValues())
        gd = src.GridData.loadFromFile(path)
        gpath = str(tmp_path / f"{src.__name__}_gd.grid")
        gd.saveToFile(gpath)
        gd2 = dst.GridData.loadFromFile(gpath)
        np.testing.assert_array_equal(gd2.getValues(), gd.getValues())
        np.testing.assert_array_equal(gd2.getDerivatives(),
                                      gd.getDerivatives())
        assert gd2.getCounts() == gd.getCounts() == (4, 3, 5)
    dst.clearGridCache()
    src.clearGridCache()


def test_save_grid_as_dx_byte_equal(tmp_path):
    f = {g: _file_force(g, 9, False) for g in (jgfp, tgfp)}
    jgridio.save_grid_as_dx(f[jgfp], str(tmp_path / "j.dx"))
    gridio.save_grid_as_dx(f[tgfp], str(tmp_path / "t.dx"))
    assert (tmp_path / "j.dx").read_bytes() == (tmp_path / "t.dx").read_bytes()
    # from a Grid
    from openmmgridforce_tpu.grid import Grid as JGrid
    vals = np.random.default_rng(10).standard_normal((3, 4, 2))
    jgridio.save_grid_as_dx(JGrid.create(vals, (0.1, 0.2, 0.3),
                                         (1.0, 2.0, 3.0), dtype=np.float64),
                            str(tmp_path / "jg.dx"))
    gridio.save_grid_as_dx(grid_from_numpy(vals, (0.1, 0.2, 0.3),
                                           (1.0, 2.0, 3.0), device="cpu"),
                           str(tmp_path / "tg.dx"))
    assert (tmp_path / "jg.dx").read_bytes() == \
        (tmp_path / "tg.dx").read_bytes()


# ----------------------------------------------------------------------
# Auto-generation and scaling
# ----------------------------------------------------------------------

@pytest.mark.parametrize("platform", ["CUDA", "Reference"])
@pytest.mark.parametrize("derivatives", [False, True])
def test_auto_generation_matches_jax(world, derivatives, platform):
    """Values to 1e-12 of the grid's max; derivatives to 1e-6 of each
    slot's max (the known 1 - tanh^2 libm gap); Q3's diameter convention
    on the reference platform."""
    got = generated(tgfp, world, derivatives, platform)
    want = generated(jgfp, world, derivatives, platform)
    for (gv, gd), (wv, wd) in zip(got, want):
        np.testing.assert_allclose(gv, wv, rtol=1e-12,
                                   atol=1e-12 * np.abs(wv).max())
        assert (gd is None) == (wd is None) == (not derivatives)
        if derivatives:
            gd, wd = gd.reshape(27, -1), wd.reshape(27, -1)
            scale = np.abs(wd).max(axis=1, keepdims=True)
            assert (np.abs(gd - wd) / scale).max() < 1e-6
    other = generated(tgfp, world, derivatives,
                      "CUDA" if platform == "Reference" else "Reference")
    assert not np.array_equal(got[1][0], other[1][0])   # Q3 for ljr


@pytest.mark.parametrize("platform", ["CUDA", "Reference"])
def test_auto_scaling_factors_match_jax(world, platform):
    """Rmin on the default platforms, (2 sigma) diameters (Q5) on the
    reference platform."""
    got = ligand_context(tgfp, world, 0, platform)
    want = ligand_context(jgfp, world, 0, platform)
    for fg, fw in zip(got.system.getForces()[4:],
                      want.system.getForces()[4:]):
        np.testing.assert_allclose(fg.getScalingFactors(),
                                   fw.getScalingFactors(), rtol=1e-15)
    lig = world["lig"]
    d = (2.0 if platform == "Reference" else 2.0 ** (1 / 6)) * lig.sigmas
    np.testing.assert_allclose(got.system.getForces()[5].getScalingFactors(),
                               np.sqrt(lig.epsilons) * d ** 6, rtol=1e-12)


# ----------------------------------------------------------------------
# Platform quirks
# ----------------------------------------------------------------------

def test_reference_quirks_q1_q4_q5(world):
    """Reference platform through a Context: forces on the loop index
    rows (Q1) for ligand atoms that are not 0..N-1, the RUNTIME
    inverse power applied to the values at Context creation (Q4), and
    diameter auto scaling (Q5); each against JAX."""
    def configure(i, f):
        f.setLigandAtoms([4, 5, 6, 7])
        if i == 1:
            f.setInvPowerMode(tgfp.InvPowerMode_RUNTIME, 4.0)

    got = ligand_context(tgfp, world, 1, "Reference", configure)
    want = ligand_context(jgfp, world, 1, "Reference", configure)
    assert_states_match(want, got)
    f = got.getState(getForces=True, groups={0}).getForces()
    assert np.any(f[:4] != 0.0)
    f1 = got.getState(getForces=True, groups={1}).getForces()
    np.testing.assert_array_equal(f1[4:], 0.0)
    assert got._grid_infos[5].grid.inv_power_mode == 2   # Q4: now STORED
    default = ligand_context(tgfp, world, 1, "CUDA", configure)
    f2 = default.getState(getForces=True, groups={1}).getForces()
    np.testing.assert_array_equal(f2[:4], 0.0)


def test_common_quirk_q6(world):
    """Common platform: the restraint force of an atom outside the box is
    scaled by its scaling factor (Q6), against JAX and against the
    default platform."""
    x = world["x"].copy()
    x[0] = np.asarray(world["origin"]) - 0.3
    ctxs = {}
    for g in (tgfp, jgfp):
        for platform in ("Common", "CUDA"):
            ctx = ligand_context(g, world, 1, platform)
            ctx.setPositions(x)
            ctxs[g, platform] = ctx
    assert_states_match(ctxs[jgfp, "Common"], ctxs[tgfp, "Common"])
    fc = ctxs[tgfp, "Common"].getState(getForces=True,
                                      groups={0}).getForces()
    fd = ctxs[tgfp, "CUDA"].getState(getForces=True, groups={0}).getForces()
    q0 = ctxs[tgfp, "CUDA"].system.getForces()[4].getScalingFactors()[0]
    k = tgfp.GridForce().getOutOfBoundsRestraint()
    # dev = -0.3 nm on each axis: F = -s k dev against -k dev
    np.testing.assert_allclose(fc[0] - fd[0], (q0 - 1.0) * k * 0.3,
                               rtol=1e-9)
    np.testing.assert_allclose(fc[1:], fd[1:], atol=1e-9)


# ----------------------------------------------------------------------
# Atom selection, energy queries, parameter updates
# ----------------------------------------------------------------------

SELECTIONS = {
    "groups": lambda i, f: (f.addParticleGroup("a", [1, 3, 5]),
                            f.addParticleGroup("b", [0, 2], [0.5, -1.5]),
                            f.setParticles([7])),
    "particles": lambda i, f: (f.setParticles([6, 2, 9]),
                               f.setLigandAtoms([1])),
    "ligand_local": lambda i, f: (f.setLigandAtoms([2, 3, 4]),
                                  f.setScalingFactors([0.3, 0.6, 0.9])),
    "ligand": lambda i, f: f.setLigandAtoms([8, 1]),
}


@pytest.mark.parametrize("selection", list(SELECTIONS))
def test_atom_selection_and_energy_queries(world, selection):
    """Particle groups > particles > ligand atoms > all: energies, forces
    and the per-group / per-atom energy queries against JAX."""
    got = ligand_context(tgfp, world, 1, "CUDA", SELECTIONS[selection])
    want = ligand_context(jgfp, world, 1, "CUDA", SELECTIONS[selection])
    assert_states_match(want, got)
    for fg, fw in zip(got.system.getForces()[4:],
                      want.system.getForces()[4:]):
        np.testing.assert_allclose(fg.getParticleGroupEnergies(),
                                   fw.getParticleGroupEnergies(),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(fg.getParticleAtomEnergies(),
                                   np.asarray(fw.getParticleAtomEnergies()),
                                   rtol=1e-10, atol=1e-12)
    if selection == "groups":
        assert len(got.system.getForces()[4].getParticleGroupEnergies()) == 2


def test_update_parameters_in_context(world):
    """New scaling factors and grid values take effect after
    updateParametersInContext, as in JAX."""
    ctxs = [ligand_context(g, world, 1, "CUDA") for g in (tgfp, jgfp)]
    e0 = ctxs[0].getState(getEnergy=True, groups={1}).getPotentialEnergy()
    for ctx in ctxs:
        f = ctx.system.getForces()[5]
        f.setScalingFactors(2.0 * np.asarray(f.getScalingFactors()))
        f.setGridValues(1.5 * np.asarray(f.getGridValues()))
        f.updateParametersInContext(ctx)
    assert_states_match(ctxs[1], ctxs[0])
    e1 = ctxs[0].getState(getEnergy=True, groups={1}).getPotentialEnergy()
    assert e1 == pytest.approx(3.0 * e0, rel=1e-12)


def test_context_runs_on_its_systems_device(world):
    """A system's terms live on the device it was built on: a Context
    elsewhere raises rather than build them a second time."""
    system = tgfp.create_system(world["lig"], device="cpu")
    with pytest.raises(ValueError, match="same device"):
        tgfp.Context(system, tgfp.VerletIntegrator(0.001), device="meta")


def test_isolated_nonbonded_force(world):
    """IsolatedNonbondedForce with exclusions, exceptions and a particle
    map, inside a Context, against JAX."""
    out = []
    for g in (tgfp, jgfp):
        system = g.create_system(_top(g, world["lig"]), **_kw(g))
        iso = g.IsolatedNonbondedForce()
        iso.setNumAtoms(5)
        for i in range(5):
            iso.setAtomParameters(i, *np.random.default_rng(i).uniform(
                (-0.5, 0.2, 0.1), (0.5, 0.3, 0.9)))
        iso.setParticles([9, 2, 4, 6, 0])
        iso.addExclusion(0, 1)
        iso.addExclusion(2, 4)
        iso.addException(1, 2, 0.1, 0.25, 0.3)
        iso.addException(2, 4, 0.0, 0.3, 0.0)
        iso.setForceGroup(5)
        system.addForce(iso)
        ctx = g.Context(system, g.VerletIntegrator(0.001), **_kw(g))
        ctx.setPositions(world["x"])
        out.append(ctx)
    assert_states_match(out[1], out[0], groups=(None, {5}))
    f = out[0].getState(getForces=True, groups={5}).getForces()
    np.testing.assert_array_equal(f[[1, 3, 5, 7, 8]], 0.0)


def test_readme_compat_example_runs_on_the_host(tmp_path, monkeypatch,
                                                world):
    """The README's compat-API example for the port, on the CPU (its
    ``device="cuda"`` made ``"cpu"``, 20 steps for 1000), against files
    of the synthetic ligand."""
    import re
    from pathlib import Path

    from test_torch_mm import write_inpcrd, write_prmtop

    monkeypatch.chdir(tmp_path)
    write_prmtop(tmp_path / "ligand.prmtop", world["lig"])
    write_inpcrd(tmp_path / "ligand.inpcrd", world["x"])
    vals, _ = generated(tgfp, world, False, "CUDA")[0]
    f = tgfp.GridForce()
    _geometry(f, world)
    f.setGridType("charge")
    f.setGridValues(vals)
    f.saveToFile("charge.grid")
    readme = Path(__file__).resolve().parents[1] / "README.md"
    blocks = [b for b in re.findall(r"```python\n(.*?)```",
                                    readme.read_text(), re.DOTALL)
              if "import openmmgridforce_tpu_torch.api as gfp" in b]
    assert len(blocks) == 1
    src = blocks[0]
    for old, new in (('device="cuda"', 'device="cpu"'),
                     ("step(1000)", "step(20)")):
        assert old in src
        src = src.replace(old, new)
    ns = {}
    exec(compile(src, "README-compat-port", "exec"), ns)
    x = ns["ctx"].getPositions()
    assert np.isfinite(x).all() and not np.array_equal(x, world["x"])
