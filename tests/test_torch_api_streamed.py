"""Port compat API on tiled (OMGTILE) files, on the CPU in float64
regions.

A Context whose auto-generation writes its grid to a tiled file and then
streams it steps Verlet on the in-memory Context's trajectory (the file
holds float32 values: 1e-5 relative, as tests/test_tiled_pipeline.py
holds JAX's), and on the JAX streamed Context's over the same file to
1e-10 nm (both evaluators' regions made float64: the JAX one's
``Grid.create`` is handed ``dtype=float64``, the port's evaluator
``dtype=torch.float64``). Streamed minimisation escalates an oversized
cloud onto the full grid on the Context's own device, and a
self-reversing excursion is caught by the running bounding box (the
counterparts of tests/test_tiled_pipeline.py:154 and :193, on
``chip_smoke.synthetic_complex``'s ligand)."""


import numpy as np
import pytest
import torch

import chip_smoke
import openmmgridforce_tpu.api as jgfp
import openmmgridforce_tpu_torch.api as tgfp
from openmmgridforce_tpu.grid import Grid as JGrid
from openmmgridforce_tpu.io import streaming as jstreaming
from openmmgridforce_tpu_torch.io import streaming, write_grid_tiled
from openmmgridforce_tpu_torch.ops import gridgen
from test_torch_api import jax_topology

torch.set_num_threads(1)
RNG = np.random.default_rng(19)


class _JGridF64:
    @staticmethod
    def create(*args, **kw):
        kw["dtype"] = np.float64
        return JGrid.create(*args, **kw)


class _Evaluator64(streaming.StreamedGridEvaluator):
    def __init__(self, *args, **kw):
        kw["dtype"] = torch.float64
        super().__init__(*args, **kw)


@pytest.fixture
def regions_in_f64(monkeypatch):
    monkeypatch.setattr(jstreaming, "Grid", _JGridF64)
    monkeypatch.setattr(streaming, "StreamedGridEvaluator", _Evaluator64)


def _receptor(n):
    from openmmgridforce_tpu_torch.mm.amber import AmberTopology
    q = RNG.uniform(-0.4, 0.4, n)
    z2, z = np.zeros((0, 2), np.int64), np.zeros(0)
    top = AmberTopology(
        natom=n, masses=np.full(n, 12.0), charges=q,
        sigmas=RNG.uniform(0.25, 0.35, n), epsilons=RNG.uniform(0.2, 0.8, n),
        atom_names=["C"] * n, residue_labels=["REC"],
        residue_pointers=np.array([1]), bond_idx=z2, bond_k=z, bond_r0=z,
        angle_idx=np.zeros((0, 3), np.int64), angle_k=z, angle_t0=z,
        torsion_idx=np.zeros((0, 4), np.int64), torsion_k=z, torsion_per=z,
        torsion_phase=z, exclusions=[], pairs14=z2, scee=z, scnb=z)
    return top, q


def _probe_context(g, top, q, rec_pos, counts, tiled=None, tiled_in=None,
                   region=None):
    """The receptor's own atoms as probes of their charge grid (tests/
    test_tiled_pipeline.py's set-up): in memory, generated to ``tiled``
    and streamed, or streamed from ``tiled_in``."""
    kw = {} if g is jgfp else {"device": "cpu"}
    system = g.create_system(jax_topology(top) if g is jgfp else top, **kw)
    f = g.GridForce()
    f.addGridCounts(*counts)
    f.addGridSpacing(0.07, 0.07, 0.07)
    f.setGridOrigin(0.0, 0.0, 0.0)
    if tiled_in:
        f.setTiledInputFile(tiled_in)
    else:
        f.setAutoGenerateGrid(True)
        f.setGridType("charge")
        f.setReceptorAtoms(list(range(len(q))))
        f.setReceptorPositionsFromLists(rec_pos)
    f.setScalingFactors(q * 0.05)
    if tiled:
        f.setTiledOutputFile(tiled, 8)
        f.setTiledMode(True, tile_size=8)
    if region:
        f.setStreamRegionShape(*region)
    system.addForce(f)
    ctx = g.Context(system, g.VerletIntegrator(0.0005), **kw)
    ctx.setPositions(rec_pos * 0.8 + 0.1)
    return ctx


def test_streamed_verlet_matches_memory_and_jax(tmp_path, regions_in_f64):
    top, q = _receptor(12)
    rec_pos = RNG.uniform(0.0, 1.0, (12, 3))
    counts = (16, 16, 16)
    path = str(tmp_path / "md.tiled")
    mem = _probe_context(tgfp, top, q, rec_pos, counts)
    ctx = _probe_context(tgfp, top, q, rec_pos, counts, tiled=path)
    assert ctx.system.getForces()[4].getTiledInputFile() == path
    jctx = _probe_context(jgfp, top, q, rec_pos, counts, tiled_in=path)
    e = [c.getState(getEnergy=True).getPotentialEnergy()
         for c in (mem, ctx, jctx)]
    assert e[1] == pytest.approx(e[0], rel=2e-5, abs=1e-6)
    assert e[1] == pytest.approx(e[2], rel=1e-10)
    for c in (ctx, jctx):
        c.stream_refresh_steps = 10          # several region refreshes
    for c in (mem, ctx, jctx):
        c.getIntegrator().step(35)
    np.testing.assert_allclose(ctx.getPositions(), mem.getPositions(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ctx.getPositions(),
                               np.asarray(jctx.getPositions()),
                               rtol=0, atol=1e-10)
    # region hysteresis and the packed-region LRU serve every segment
    # after the first from one region read (and getState read one of its
    # own), as in JAX
    misses = [c._grid_infos[4].streamer.region_misses for c in (ctx, jctx)]
    assert misses == [2, 2]
    e0 = ctx.getState(getEnergy=True).getPotentialEnergy()
    sim = tgfp.Simulation(top, ctx.system, ctx.integrator, device="cpu")
    sim.context = ctx
    sim.minimizeEnergy(maxIterations=30, tolerance=1.0)
    assert ctx.getState(getEnergy=True).getPotentialEnergy() <= e0 + 1e-9


def test_streamed_minimize_escalates_on_the_device(tmp_path):
    """A region smaller than the cloud: minimisation escalates the set to
    the full grid, which lives on the Context's device, and the energy
    goes down."""
    top, q = _receptor(12)
    rec_pos = RNG.uniform(0.0, 1.0, (12, 3))
    ctx = _probe_context(tgfp, top, q, rec_pos, (16, 16, 16),
                         tiled=str(tmp_path / "esc.tiled"), region=(8, 8, 8))
    e0 = ctx.getState(getEnergy=True).getPotentialEnergy()
    sim = tgfp.Simulation(top, ctx.system, ctx.integrator, device="cpu")
    sim.context = ctx
    sim.minimizeEnergy(maxIterations=20, tolerance=1.0)
    assert ctx.getState(getEnergy=True).getPotentialEnergy() <= e0 + 1e-9
    sets = ctx._ensure_stream_engine().sets
    assert any(s.full_escalations > 0 for s in sets)
    full = [s._full_pay for s in sets if s._full_pay is not None]
    assert full and all(g.vals.device == ctx.device
                        for pay in full for g in pay[0])


def test_streamed_detects_self_reversing_excursion(tmp_path):
    """A ligand launched from outside the grid: the full-box restraint
    slingshots it across the box faster than a region can follow. With
    escalation off the crossing raises; with it on the run completes with
    the violator on the full grid."""
    lig, lig_x, _, _ = chip_smoke.synthetic_complex(3, n_ligand=10,
                                                    n_receptor=10)
    lig_x = lig_x - lig_x.min(0)
    counts, spacing, origin = (33, 33, 33), (0.1,) * 3, (-0.8,) * 3
    rng = np.random.default_rng(31)
    rec = rng.uniform(-0.5, 2.2, (15, 3))
    q = rng.uniform(-0.2, 0.2, 15)
    system = tgfp.create_system(lig, device="cpu")
    for gt in ("charge", "lja"):
        grid = gridgen.generate_grid(
            counts, spacing, origin, gt, rec, q, np.full(15, 0.32),
            np.full(15, 0.4), dtype=torch.float64, device="cpu")
        path = str(tmp_path / f"{gt}.tiled")
        write_grid_tiled(path, grid, tile_size=8)
        g = tgfp.GridForce()
        g.setTiledInputFile(path)
        g.setInterpolationMethod(1)
        g.setStreamRegionShape(26, 26, 26)
        g.setScalingFactors(gridgen.auto_scaling_factors(
            gt, lig.charges, lig.sigmas, lig.epsilons))
        system.addForce(g)

    def context(budget=None):
        ctx = tgfp.Context(system, tgfp.LangevinIntegrator(0.0, 0.2, 0.001),
                           device="cpu")
        ctx.setPositions(lig_x + 4.0)
        ctx.setVelocities(np.zeros_like(lig_x))
        ctx.stream_refresh_steps = 400
        if budget is not None:
            ctx.stream_full_region_budget_bytes = budget
        return ctx

    unescalated = context(budget=0)
    with pytest.raises(RuntimeError, match="crossed their streamed"):
        unescalated.getIntegrator().step(400)
    ctx = context()
    ctx.getIntegrator().step(400)
    assert any(s.full_escalations > 0
               for s in ctx._ensure_stream_engine().sets)
    assert np.isfinite(ctx.getPositions()).all()
