"""The port's sharded grids on gloo ranks on the host vs the JAX package
(float64): evaluation of packs split over 3 sp ranks (trilinear, B-spline,
a triquintic Chebyshev pack, fused tricubic and triquintic Hermite rows;
20 x-cells do not divide by 3) against JAX's unsharded evaluators and its
``make_sharded_grid_eval`` on 3 of conftest's virtual devices; x-slab
generation of values and 27 derivatives over 4 ranks on 5 x-points (one
rank gets none) against JAX's ``generate_grid_sharded`` and the port's own
``generate_grid``; and packs made from the slabs with their halo,
row for row equal to the single-device pack.

Each module starts its ranks once (``distributed.launch``); the ranks run
the worker functions below, so this module imports no JAX at its top: a
spawned rank imports it and must not load JAX.
"""

import numpy as np
import pytest
import torch

from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.grid import InterpolationMethod, grid_from_numpy
from openmmgridforce_tpu_torch.ops import gridgen, packed
from openmmgridforce_tpu_torch.parallel import (Mesh, distributed,
                                                generate_grid_sharded,
                                                make_sharded_grid_eval,
                                                pack_sharded,
                                                shard_packed_grid)

COUNTS = (21, 10, 12)        # 20 x-cells: 7, 7 and 6 (+1 padding) on 3 ranks
SPACING = (0.1, 0.12, 0.09)
ORIGIN = (0.0, 0.0, 0.0)
N_SP = 3
OOB_K = 333.0
# case -> (interpolation method, how it is packed)
CASES = {"trilinear": (InterpolationMethod.TRILINEAR, "pack"),
         "bspline": (InterpolationMethod.BSPLINE, "pack"),
         "triquintic_chebyshev": (InterpolationMethod.TRIQUINTIC, "pack"),
         "tricubic_hermite": (InterpolationMethod.TRICUBIC, "hermite"),
         "triquintic_hermite": (InterpolationMethod.TRIQUINTIC, "hermite")}

GEN_COUNTS = (5, 6, 5)       # 2, 2, 1 and 0 x-rows on 4 ranks
GEN_SPACING = (0.1, 0.1, 0.1)
GEN_ORIGIN = (0.05, 0.05, 0.05)
N_GEN = 4


def _port_pack(case, data):
    """The port's single-device pack of a case's grids (on the host)."""
    method, how = CASES[case]
    grids = [grid_from_numpy(v, SPACING, ORIGIN, derivs=d,
                             interp_method=method, oob_k=OOB_K,
                             dtype=torch.float64, device="cpu")
             for v, d in zip(data["vals"], data["derivs"])]
    if how == "hermite":
        return packed.combine_hermite_packed(
            [packed.pack_grid_hermite(g) for g in grids])
    basis = "chebyshev" if method == InterpolationMethod.TRIQUINTIC \
        else None
    return packed.pack_grid(grids[0], poly_basis=basis)


def eval_worker(device, cases, positions, scaling):
    """Every case's port pack split over sp, and the JAX table converted,
    evaluated at the same positions; per rank: rows held and results."""
    mesh = Mesh((N_SP,), ("sp",), device)
    evaluate = make_sharded_grid_eval(mesh)
    out = {}
    for case, data in cases.items():
        s = scaling if CASES[case][1] == "hermite" else scaling[0]
        sharded = shard_packed_grid(_port_pack(case, data), mesh)
        res = evaluate(sharded, torch.from_numpy(positions),
                       torch.from_numpy(s))
        conv = convert.sharded_packed_from_arrays(mesh=mesh,
                                                  **data["jax_table"])
        res_j = evaluate(conv, torch.from_numpy(positions),
                         torch.from_numpy(s))
        out[case] = {"rows": sharded.coeffs.shape[0],
                     "ncx_padded": sharded.ncx_padded,
                     "form": sharded.form,
                     "per_atom": res.per_atom_energy, "forces": res.forces,
                     "energy": res.energy,
                     "jax_table_per_atom": res_j.per_atom_energy,
                     "jax_table_forces": res_j.forces}
    return out


def _gen_args():
    rng = np.random.default_rng(5)
    return (rng.uniform(0.0, 1.2, (20, 3)), rng.uniform(-0.5, 0.5, 20),
            rng.uniform(0.25, 0.35, 20), rng.uniform(0.3, 0.8, 20))


def gen_worker(device):
    """Slabs of values (charge, ljr: B-spline and trilinear) and of 27
    derivatives (charge, lja: triquintic), the gathered grids, and packs
    made from the slabs against the single-device packs' rows."""
    mesh = Mesh((N_GEN,), ("sp",), device)
    rec, q, sig, eps = _gen_args()

    def slabs(method, derivs, types):
        return [generate_grid_sharded(
            mesh, GEN_COUNTS, GEN_SPACING, GEN_ORIGIN, gt, rec, q, sig, eps,
            compute_derivatives=derivs, interp_method=method, oob_k=OOB_K,
            dtype=torch.float64) for gt in types]

    out = {}
    for name, method, derivs, types in (
            ("bspline", InterpolationMethod.BSPLINE, False,
             ("charge", "ljr")),
            ("trilinear", InterpolationMethod.TRILINEAR, False,
             ("charge",)),
            ("triquintic", InterpolationMethod.TRIQUINTIC, True,
             ("charge", "lja"))):
        parts = slabs(method, derivs, types)
        whole = [s.gather() for s in parts]
        packs = {"pack": (pack_sharded(parts, x_chunk=1),
                          packed.pack_grids_fused(whole, device=device))}
        out[name] = {
            "x_range": parts[0].x_range,
            "vals": [s.vals for s in parts],
            "derivs": [s.derivs for s in parts],
            "gathered": [g.vals for g in whole],
            "gathered_derivs": [g.derivs for g in whole],
            "rows_equal": {k: torch.equal(mine.coeffs, shard_packed_grid(
                ref, mesh).coeffs) for k, (mine, ref) in packs.items()},
            "rows": {k: mine.coeffs.shape[0]
                     for k, (mine, _) in packs.items()}}
    return out


@pytest.fixture(scope="module")
def eval_inputs():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from openmmgridforce_tpu import Grid as JGrid
    from openmmgridforce_tpu.grid import InterpolationMethod as JMethod
    from openmmgridforce_tpu.ops import gridgen as jgridgen
    from openmmgridforce_tpu.ops import packed as jpacked
    from openmmgridforce_tpu.parallel import sharded_grid as jsharded

    rng = np.random.default_rng(61)
    rec = rng.uniform(0.1, 1.5, (10, 3))
    q = np.abs(rng.uniform(-0.4, 0.4, 10))
    lo = np.asarray(ORIGIN) - 0.1
    hi = np.asarray(ORIGIN) + (np.asarray(COUNTS) - 1) * np.asarray(
        SPACING) + 0.1
    positions = rng.uniform(lo, hi, size=(64, 3))   # some outside the box
    scaling = rng.standard_normal((2, 64))
    scaling[:, 5] = 0.0
    jmesh = JMesh(np.asarray(jax.devices()[:N_SP]), ("sp",))
    jeval = jax.jit(jsharded.make_sharded_grid_eval(jmesh))

    cases, want = {}, {}
    for case, (method, how) in CASES.items():
        jm = JMethod(int(method))
        if how == "hermite" or method == InterpolationMethod.TRIQUINTIC:
            jgrids = [jgridgen.generate_grid(
                COUNTS, SPACING, ORIGIN, t, rec, q, np.full(10, 0.3),
                np.full(10, 0.5), compute_derivatives=True,
                interp_method=jm, oob_k=OOB_K, backend="jnp",
                dtype=jnp.float64) for t in ("charge", "lja")]
        else:
            jgrids = [JGrid.create(rng.standard_normal(COUNTS), SPACING,
                                   ORIGIN, interp_method=jm, oob_k=OOB_K,
                                   dtype=np.float64)]
        if how == "hermite":
            jpack = jpacked.combine_hermite_packed(
                [jpacked.pack_grid_hermite(g) for g in jgrids])
            ref = jpacked.evaluate_hermite_multi(jpack, positions, scaling)
            s = scaling
        else:
            jgrids = jgrids[:1]
            basis = ("chebyshev" if method == InterpolationMethod.TRIQUINTIC
                     else None)
            jpack = jpacked.pack_grid(jgrids[0], poly_basis=basis)
            ref = jpacked.evaluate_packed(jpack, positions, scaling[0])
            s = scaling[0]
        jsh = jsharded.shard_packed_grid(jpack, jmesh)
        got = jeval(jsh, jnp.asarray(positions), jnp.asarray(s))
        cases[case] = {
            "vals": [np.asarray(g.vals) for g in jgrids],
            "derivs": [None if g.derivs is None else np.asarray(g.derivs)
                       for g in jgrids],
            "jax_table": {
                "coeffs": np.asarray(jsh.coeffs),
                "spacing": np.asarray(jsh.spacing),
                "origin": np.asarray(jsh.origin), "counts": jsh.counts,
                "degree": jsh.degree, "n_grids": jsh.n_grids,
                "back_powers": jsh.back_powers, "oob_k": jsh.oob_k,
                "ncx_padded": jsh.ncx_padded, "form": jsh.form,
                "method": jsh.method, "poly_basis": jsh.poly_basis}}
        want[case] = {"unsharded": ref, "sharded": got}
    return cases, positions, scaling, want


@pytest.fixture(scope="module")
def eval_ranks(eval_inputs):
    cases, positions, scaling, _ = eval_inputs
    return distributed.launch(eval_worker, N_SP,
                              (cases, positions, scaling), device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_eval_matches_jax(eval_inputs, eval_ranks, case):
    """Every rank ends with the whole result: JAX's unsharded evaluator
    and JAX's shard_map'd one, at 1e-12, OOB atoms and a zero scaling
    included."""
    want = eval_inputs[3][case]
    for rank in eval_ranks:
        got = rank[case]
        for ref in (want["unsharded"], want["sharded"]):
            np.testing.assert_allclose(got["per_atom"].numpy(),
                                       np.asarray(ref.per_atom_energy),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(got["forces"].numpy(),
                                       np.asarray(ref.forces), rtol=1e-12,
                                       atol=1e-12)
            assert float(got["energy"]) == pytest.approx(
                float(ref.energy), rel=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_converted_jax_table_evaluates_alike(eval_inputs, eval_ranks, case):
    """JAX's own sharded table, brought across by convert, gives the
    port's sharded result."""
    for rank in eval_ranks:
        got = rank[case]
        np.testing.assert_allclose(got["jax_table_per_atom"].numpy(),
                                   got["per_atom"].numpy(), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(got["jax_table_forces"].numpy(),
                                   got["forces"].numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_each_rank_holds_its_slab(eval_ranks):
    ncy, ncz = COUNTS[1] - 1, COUNTS[2] - 1
    for case in CASES:
        forms = {r[case]["form"] for r in eval_ranks}
        assert forms == {"hermite" if "hermite" in case else "monomial"}
        for rank in eval_ranks:
            assert rank[case]["ncx_padded"] == 21
            assert rank[case]["rows"] == 21 // N_SP * ncy * ncz


@pytest.fixture(scope="module")
def gen_ranks():
    return distributed.launch(gen_worker, N_GEN, device="cpu")


def _clamp_distance(rec):
    """Each generation point's distance to its nearest receptor atom."""
    axes = [o + h * np.arange(n) for o, h, n in
            zip(GEN_ORIGIN, GEN_SPACING, GEN_COUNTS)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    return np.sqrt(((pts[..., None, :] - rec) ** 2).sum(-1)).min(-1)


@pytest.mark.parametrize("name,derivs", [("bspline", False),
                                         ("triquintic", True)])
def test_sharded_generation_matches_jax_and_one_device(gen_ranks, name,
                                                       derivs):
    """The slabs' union and the gathered grid against JAX's
    generate_grid_sharded on 4 devices (1e-12; at the one point inside
    the derivative clamp, JAX's Pallas K2) and the port's own
    generate_grid (bit for bit)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from openmmgridforce_tpu.grid import InvPowerMode
    from openmmgridforce_tpu.ops import gridgen as jgridgen
    from openmmgridforce_tpu.ops.pallas_gridgen_derivs import (
        generate_raw_derivs_pallas)
    from openmmgridforce_tpu.parallel import generate_grid_sharded as jgen
    from openmmgridforce_tpu.units import DEFAULT_GRID_CAP

    rec, q, sig, eps = _gen_args()
    jmesh = JMesh(np.asarray(jax.devices()[:N_GEN]), ("sp",))
    types = ("charge", "lja") if derivs else ("charge", "ljr")
    for gi, gt in enumerate(types):
        ref = jgen(jmesh, GEN_COUNTS, GEN_SPACING, GEN_ORIGIN, gt, rec, q,
                   sig, eps, compute_derivatives=derivs,
                   dtype=jnp.float64)
        mine = gridgen.generate_grid(GEN_COUNTS, GEN_SPACING, GEN_ORIGIN,
                                     gt, rec, q, sig, eps,
                                     compute_derivatives=derivs,
                                     dtype=torch.float64, device="cpu")
        key = "derivs" if derivs else "vals"
        union = torch.cat([r[name][key][gi] for r in gen_ranks])
        want = np.asarray(ref.derivs if derivs else ref.vals)
        if derivs:
            # 1e-12 of each slot's largest value, at the points outside
            # the derivative clamp (r^2 >= 4e-4 nm^2) of every atom: at the
            # one point inside it JAX's jnp route (which its sharded
            # generation takes) and its Pallas K2, which the port follows,
            # disagree
            far = _clamp_distance(rec) > 0.02
            assert (~far).sum() == 1
            err = np.abs(union.numpy() - want)[far].max(0)
            assert (err <= 1e-12 * np.abs(want[far]).max(0)).all()
            # at that point the port agrees with JAX's Pallas K2 (interpret
            # mode, then JAX's own chain rules) within 1e-3 of each slot's
            # largest value (the kernel's float32 sums cancel there: 5.6e-4
            # at most), where the jnp route is off by up to 0.79 (charge)
            # and 5.5 (lja) of it
            raw = generate_raw_derivs_pallas(
                GEN_COUNTS, GEN_SPACING, GEN_ORIGIN, gt, rec, q, sig, eps,
                interpret=True)
            pallas = np.asarray(jgridgen._postprocess_raw_derivs(
                raw, grid_cap=DEFAULT_GRID_CAP, inv_power=0.0,
                inv_power_mode=InvPowerMode.NONE, spacing=GEN_SPACING),
                np.float64)
            gate = 1e-3 * np.abs(pallas).max((0, 1, 2))
            at = union.numpy()[~far][0]
            assert (np.abs(at - pallas[~far][0]) <= gate).all()
            assert (np.abs(want[~far][0] - pallas[~far][0]) > gate).any()
        else:
            np.testing.assert_allclose(union.numpy(), want, rtol=1e-12,
                                       atol=1e-12)
        assert torch.equal(union, getattr(mine, key))
        for r in gen_ranks:
            assert torch.equal(r[name]["gathered"][gi], mine.vals)
            if derivs:
                assert torch.equal(r[name]["gathered_derivs"][gi],
                                   mine.derivs)


def test_rank_without_rows(gen_ranks):
    """nx = 5 over 4 ranks: 2, 2, 1 and 0 rows; the empty rank launched
    nothing and still took part in the gathers and the halo exchange."""
    assert [r["bspline"]["x_range"] for r in gen_ranks] == [
        (0, 2), (2, 4), (4, 5), (5, 5)]
    empty = gen_ranks[3]["triquintic"]
    assert empty["vals"][0].shape == (0, 6, 5)
    assert empty["derivs"][0].shape == (0, 6, 5, 27)


@pytest.mark.parametrize("name,kind", [("bspline", "pack"),
                                       ("trilinear", "pack"),
                                       ("triquintic", "pack")])
def test_halo_pack_equals_single_device_rows(gen_ranks, name, kind):
    """Packs made on each rank from its slab and the planes its neighbours
    sent hold the single-device pack's rows of its cells, bit for bit
    (4 x-cells over 4 ranks: one cell each)."""
    for r in gen_ranks:
        assert r[name]["rows_equal"][kind]
        assert r[name]["rows"][kind] == (GEN_COUNTS[1] - 1) * (
            GEN_COUNTS[2] - 1)
