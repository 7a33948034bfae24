"""The port's slices as wholes against the JAX package (float64, CPU):
receptor grids -> packs -> fused table -> System -> replica states ->
classic-Langevin segment, on the value path (B-spline packs) and on the
derivative path (grids with 27 derivatives, triquintic Chebyshev packs).
The JAX replica states are carried across with convert.py and both
segments get the same noise."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from openmmgridforce_tpu.grid import Grid as JGrid
from openmmgridforce_tpu.grid import InterpolationMethod as JMethod
from openmmgridforce_tpu.mm import system as jsystem
from openmmgridforce_tpu.mm.integrators import instantaneous_temperature
from openmmgridforce_tpu.ops import gridgen as jgridgen
from openmmgridforce_tpu.ops import packed as jpacked
from openmmgridforce_tpu.parallel import replicas as jrep
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.grid import InterpolationMethod
from openmmgridforce_tpu_torch.mm import system
from openmmgridforce_tpu_torch.ops import gridgen, packed

torch.set_num_threads(1)

GRID_TYPES = ("charge", "ljr", "lja")
N_REPLICAS = 4


def _jax_noise(keys, n_steps, shape):
    """The normals JAX's classic Langevin step draws from each replica's
    key, [n_steps, R, *shape]: one split per step, as the step does."""
    def one(key):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.normal(sub, shape, dtype=jnp.float64)
        return jax.lax.scan(body, key, None, length=n_steps)[1]
    return np.array(jnp.swapaxes(jax.vmap(one)(keys), 0, 1))


def _run_slice(lig, x, rec, rec_x, margin, sp, n_steps, derivatives=False):
    """Both packages from the same complex; returns (JAX final states,
    port final states, JAX system, JAX binding, port system, port
    binding, grid origin, grid counts). ``derivatives``: the derivative
    path (triquintic grids, Chebyshev packs) instead of the value path."""
    lo = x.min(0) - margin
    spacing = (sp,) * 3
    counts = tuple(int(c) + 1 for c in
                   np.ceil((x.max(0) + margin - lo) / sp))

    method = "TRIQUINTIC" if derivatives else "BSPLINE"
    basis = "chebyshev" if derivatives else "monomial"
    # the derivative grids agree to 1e-6 of each slot's max, not 1e-10:
    # between the cap's passthrough and its saturation 1 - tanh^2, taken
    # from two libms, multiplies products of large raw derivatives
    grid_tol = 1e-6 if derivatives else 1e-10
    jpacks, tpacks, scal = [], [], []
    for gt in GRID_TYPES:
        jg = jgridgen.generate_grid(
            counts, spacing, lo, gt, rec_x, rec.charges, rec.sigmas,
            rec.epsilons, interp_method=JMethod[method], backend="jnp",
            compute_derivatives=derivatives, dtype=jnp.float64)
        tg = gridgen.generate_grid(
            counts, spacing, lo, gt, rec_x, rec.charges, rec.sigmas,
            rec.epsilons, interp_method=InterpolationMethod[method],
            compute_derivatives=derivatives, dtype=torch.float64,
            device="cpu")
        jv = np.asarray(jg.derivs if derivatives else jg.vals)
        tv = (tg.derivs if derivatives else tg.vals).numpy()
        axes = (0, 1, 2)
        assert (np.abs(tv - jv).max(axes)
                <= grid_tol * np.abs(jv).max(axes)).all()
        jpacks.append(jpacked.pack_grid(JGrid.create(
            np.asarray(jg.vals), spacing, lo, derivs=jg.derivs,
            interp_method=JMethod[method], dtype=jnp.float64),
            poly_basis=basis))
        tpacks.append(packed.pack_grid(tg, poly_basis=basis))
        scal.append(gridgen.auto_scaling_factors(gt, lig.charges,
                                                 lig.sigmas, lig.epsilons))
    jmulti = jpacked.combine_packed_grids(jpacks)
    tmulti = packed.combine_packed_grids(tpacks)
    conv = convert.multi_packed_from_arrays(
        np.asarray(jmulti.coeffs), np.asarray(jmulti.spacing),
        np.asarray(jmulti.origin), counts=jmulti.counts,
        degree=jmulti.degree, n_grids=jmulti.n_grids,
        back_powers=jmulti.back_powers, oob_k=jmulti.oob_k,
        poly_basis=jmulti.poly_basis, device="cpu")
    c = conv.coeffs.numpy()
    if derivatives:
        np.testing.assert_allclose(tmulti.coeffs.numpy(), c, rtol=0,
                                   atol=grid_tol * np.abs(c).max())
    else:
        np.testing.assert_allclose(tmulti.coeffs.numpy(), c, rtol=1e-9,
                                   atol=1e-12 * np.abs(c).max())
    scal = np.stack(scal)
    jb = jsystem.GridBinding(grid=jmulti, scaling=jnp.asarray(scal))
    tb = system.GridBinding(grid=tmulti, scaling=torch.from_numpy(scal))

    js = jsystem.system_from_amber(lig, dtype=jnp.float64, hydrogen_mass=4.0)
    ts = system.system_from_amber(lig, dtype=torch.float64,
                                  hydrogen_mass=4.0, device="cpu")
    ts_conv = convert.system_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in convert.SYSTEM_FIELDS},
        {f: np.asarray(getattr(js.pairs, f)) for f in convert.PAIR_FIELDS},
        device="cpu")
    for f in convert.SYSTEM_FIELDS:
        assert torch.equal(getattr(ts, f), getattr(ts_conv, f)), f

    R = N_REPLICAS
    jstates = jrep.init_replica_states(jax.random.PRNGKey(2),
                                       jnp.asarray(x), js.masses, 300.0, R)
    ref = jsystem.make_md_runner(n_steps, 0.001, 5.0)(
        jstates, js, [jb], jnp.full((R,), 300.0))
    noise = _jax_noise(jstates.key, n_steps, x.shape)
    tstates = convert.states_from_arrays(np.asarray(jstates.positions),
                                         np.asarray(jstates.velocities),
                                         seed=0, device="cpu")
    run = system.make_md_runner(n_steps, 0.001, 5.0, device="cpu")
    got = run(tstates, ts, [tb], 300.0, noise=torch.from_numpy(noise))
    return ref, got, js, jb, ts, tb, lo, counts


def test_slice_matches_jax():
    lig, x, rec, rec_x = chip_smoke.synthetic_complex(
        5, n_ligand=12, n_receptor=30)
    ref, got, js, jb, ts, tb, _, counts = _run_slice(
        lig, x, rec, rec_x, margin=0.45, sp=0.1, n_steps=10)
    assert 900 < np.prod(counts) < 3000       # a grid of about 12^3
    moved = np.abs(np.asarray(ref.positions) - x).max()
    assert moved > 1e-3                       # the segment did something
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(ref.positions), rtol=0, atol=1e-8)
    e, _ = system.energy_and_forces(ts, [tb], got.positions)
    je = [float(jsystem.energy_and_forces(js, [jb], ref.positions[r])[0])
          for r in range(N_REPLICAS)]
    np.testing.assert_allclose(e.numpy(), je, rtol=1e-8)


def test_derivative_slice_matches_jax():
    """The derivative path as a whole: triquintic grids with 27
    derivatives from both packages, Chebyshev packs (degree 6, 216
    coefficients per cell and grid), 4 replicas, 100 steps, the same
    noise. Receptor atoms stand inside the grid box, so it holds points
    that pass through the cap, capped points and saturated ones. Positions
    within 1e-8 nm, as on the value path: the grids agree to only 1e-6 of
    each slot's max where the cap bends them, next to receptor atoms, but
    the ligand stays in the smooth field, where they agree to rounding."""
    lig, x, rec, rec_x = chip_smoke.synthetic_complex(
        6, n_ligand=12, n_receptor=40, gap=0.5)
    ref, got, js, jb, ts, tb, lo, counts = _run_slice(
        lig, x, rec, rec_x, margin=0.6, sp=0.15, n_steps=100,
        derivatives=True)
    assert tb.grid.degree == 6 and tb.grid.poly_basis == "chebyshev"
    assert tb.grid.coeffs.shape[1] == 3 * 216
    assert 1000 < np.prod(counts) < 2500      # a grid of about 12^3
    hi = lo + (np.array(counts) - 1) * 0.15
    assert ((rec_x > lo) & (rec_x < hi)).all(1).sum() >= 3
    moved = np.abs(np.asarray(ref.positions) - x).max()
    assert moved > 1e-2
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(ref.positions), rtol=0, atol=1e-8)
    e, f = system.energy_and_forces(ts, [tb], got.positions)
    for r in range(N_REPLICAS):
        je, jf = jsystem.energy_and_forces(js, [jb], ref.positions[r])
        np.testing.assert_allclose(float(e[r]), float(je), rtol=1e-8)
        np.testing.assert_allclose(f[r].numpy(), np.asarray(jf), rtol=0,
                                   atol=1e-8 * np.abs(np.asarray(jf)).max())


def test_slice_matches_jax_through_capped_wells():
    """Receptor atoms 0.35 nm from the ligand, charges of sd 0.2 e, and a
    grid box that holds them: the JAX segment itself falls into capped
    Coulomb wells ("charge fusion") and heats, and the port follows it."""
    lig, x, rec, rec_x = chip_smoke.synthetic_complex(
        4, n_ligand=12, n_receptor=300, gap=0.35, charge_sd=0.2)
    ref, got, js, _, _, _, lo, counts = _run_slice(
        lig, x, rec, rec_x, margin=0.8, sp=0.05, n_steps=700)
    hi = lo + (np.array(counts) - 1) * 0.05
    assert ((rec_x > lo) & (rec_x < hi)).all(1).sum() > 100
    ref_x = np.asarray(ref.positions)
    closest = np.linalg.norm(
        ref_x[:, :, None] - rec_x[None, None], axis=-1).min(axis=(1, 2))
    ref_t = np.asarray(jax.vmap(instantaneous_temperature, (0, None))(
        ref, js.masses))
    assert closest.min() < 0.1                # a ligand atom fell in a well
    assert ref_t.max() > 5000.0               # and the replica heated
    np.testing.assert_allclose(got.positions.numpy(), ref_x, rtol=0,
                               atol=1e-8)
