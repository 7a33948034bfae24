"""The reference's grid-vs-pairwise accuracy suite held by the port.

The JAX package's ``tests/test_grid_vs_pairwise.py`` (the reference
plugin's accuracy scripts, in the suite) run through the port on the host:
generate a grid, evaluate the ligand on it, and compare the energy with an
O(L*R) float64 pairwise oracle, at the reference's gates (2%, 5% with an
inverse power). The same seeded inputs go through the JAX package, and the
port's energy equals JAX's: to 1e-12 relative in float64 (grids in memory),
to 1e-6 relative through the tiled files (stored and evaluated in float32).

Each grid is generated once per package (module caches) and evaluated by
every method that reads it.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from openmmgridforce_tpu import InterpolationMethod as JMethod
from openmmgridforce_tpu import InvPowerMode as JInvPowerMode
from openmmgridforce_tpu.io.streaming import (StreamedGridEvaluator as
                                              JStreamedGridEvaluator)
from openmmgridforce_tpu.ops import gridgen as jgridgen
from openmmgridforce_tpu.ops.interpolate import evaluate_grid as jevaluate
from openmmgridforce_tpu_torch.grid import InterpolationMethod, InvPowerMode
from openmmgridforce_tpu_torch.io.streaming import StreamedGridEvaluator
from openmmgridforce_tpu_torch.ops import gridgen
from openmmgridforce_tpu_torch.ops.interpolate import evaluate_grid
from openmmgridforce_tpu_torch.units import COULOMB_CONST, TWO_POW_ONE_SIXTH

torch.set_num_threads(1)

RNG = np.random.default_rng(7)

# --- synthetic receptor (shell) + ligand (cloud): test_grid_vs_pairwise's
N_REC = 48
_u = RNG.standard_normal((N_REC, 3))
REC_POS = 0.5 + 1.0 * _u / np.linalg.norm(_u, axis=1, keepdims=True)
REC_Q = RNG.uniform(-0.6, 0.6, N_REC)
REC_SIG = RNG.uniform(0.25, 0.35, N_REC)
REC_EPS = RNG.uniform(0.3, 0.8, N_REC)

N_LIG = 8
LIG_POS = 0.5 + RNG.uniform(-0.12, 0.12, (N_LIG, 3))
LIG_Q = RNG.uniform(-0.4, 0.4, N_LIG)
LIG_SIG = RNG.uniform(0.25, 0.35, N_LIG)
LIG_EPS = RNG.uniform(0.3, 0.8, N_LIG)

SPACING = (0.02, 0.02, 0.02)
ORIGIN = (0.2, 0.2, 0.2)
COUNTS = (31, 31, 31)           # box [0.2, 0.8]^3, ligand well inside

GATE = 0.02                     # the reference's standard pass threshold
GATE_INVPOWER = 0.05
JAX_RTOL = 1e-12                # float64, grids in memory
JAX_RTOL_TILED = 1e-6           # float32 files and evaluators

METHODS = ["TRILINEAR", "BSPLINE", "TRICUBIC", "TRIQUINTIC"]
HERMITE = ("TRICUBIC", "TRIQUINTIC")
POSITIVE_Q = (np.abs(REC_Q) + 0.05, np.abs(LIG_Q) + 0.05)


def pairwise_energy(grid_type, lig_q=LIG_Q, rec_q=REC_Q):
    """The reference oracle: double loop in float64 with the grid's own
    geometric-mean pair decomposition (Rmin = 2^(1/6) sigma)."""
    d = np.linalg.norm(LIG_POS[:, None, :] - REC_POS[None, :, :], axis=-1)
    if grid_type == "charge":
        return float((COULOMB_CONST * np.outer(lig_q, rec_q) / d).sum())
    rmin_l = TWO_POW_ONE_SIXTH * LIG_SIG
    rmin_r = TWO_POW_ONE_SIXTH * REC_SIG
    se = np.sqrt(np.outer(LIG_EPS, REC_EPS))
    if grid_type == "ljr":
        return float((se * np.outer(rmin_l**6, rmin_r**6) / d**12).sum())
    if grid_type == "lja":
        return float((-2.0 * se * np.outer(rmin_l**3, rmin_r**3)
                      / d**6).sum())
    raise ValueError(grid_type)


def scaling(grid_type):
    return gridgen.auto_scaling_factors(grid_type, LIG_Q, LIG_SIG, LIG_EPS)


# (grid_type, derivatives, inv_power, mode name, positive charges)
@functools.cache
def port_grid(grid_type, derivs, inv_power=0.0, mode="NONE",
              positive=False):
    q = POSITIVE_Q[0] if positive else REC_Q
    return gridgen.generate_grid(
        COUNTS, SPACING, ORIGIN, grid_type, REC_POS, q, REC_SIG, REC_EPS,
        compute_derivatives=derivs, inv_power=inv_power,
        inv_power_mode=InvPowerMode[mode], dtype=torch.float64,
        device="cpu")


@functools.cache
def jax_grid(grid_type, derivs, inv_power=0.0, mode="NONE",
             positive=False):
    q = POSITIVE_Q[0] if positive else REC_Q
    return jgridgen.generate_grid(
        COUNTS, SPACING, ORIGIN, grid_type, REC_POS, q, REC_SIG, REC_EPS,
        compute_derivatives=derivs, inv_power=inv_power,
        inv_power_mode=JInvPowerMode[mode], dtype=jnp.float64)


def _energies(key, method, lig_q=None, runtime=None):
    """(port, JAX) energy and the port's forces of the ligand on the grid
    ``key`` read by ``method``; ``runtime`` flips the mode to RUNTIME with
    that power after generation, as the JAX test does."""
    pg = dataclasses.replace(port_grid(*key),
                             interp_method=int(InterpolationMethod[method]))
    jg = dataclasses.replace(jax_grid(*key),
                             interp_method=int(JMethod[method]))
    if runtime is not None:
        pg = dataclasses.replace(pg, inv_power=runtime, inv_power_mode=int(
            InvPowerMode.RUNTIME))
        jg = dataclasses.replace(jg, inv_power=runtime, inv_power_mode=int(
            JInvPowerMode.RUNTIME))
    s = scaling(key[0]) if lig_q is None else lig_q
    got = evaluate_grid(pg, torch.as_tensor(LIG_POS), s)
    want = jevaluate(jg, LIG_POS, s)
    return float(got.energy), float(want.energy), got.forces.numpy()


def _check(e_port, e_jax, forces, e_ref, gate, rtol, label):
    rel = abs(e_port - e_ref) / abs(e_ref)
    assert rel < gate, f"{label}: rel={rel:.4%}"
    assert abs(e_port - e_jax) <= rtol * abs(e_jax), (label, e_port, e_jax)
    assert np.all(np.isfinite(forces)), label


def test_oracle_and_geometry_match_chip_smoke():
    """chip_smoke.py's accuracy_path runs this suite on the card from its
    own copy of the geometry and oracle: the two are the same."""
    geo = chip_smoke.accuracy_geometry()
    for name in ("REC_POS", "REC_Q", "REC_SIG", "REC_EPS", "LIG_POS",
                 "LIG_Q", "LIG_SIG", "LIG_EPS"):
        np.testing.assert_array_equal(geo[name], globals()[name])
    assert (geo["COUNTS"], geo["SPACING"], geo["ORIGIN"]) == (
        COUNTS, SPACING, ORIGIN)
    for gt in ("charge", "ljr", "lja"):
        assert chip_smoke.accuracy_pairwise(geo, gt) == pairwise_energy(gt)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("grid_type", ["charge", "ljr", "lja"])
def test_grid_vs_pairwise(method, grid_type):
    e, ej, f = _energies((grid_type, method in HERMITE), method)
    _check(e, ej, f, pairwise_energy(grid_type), GATE, JAX_RTOL,
           f"{grid_type}/{method}")


def test_stored_invpower_n2_charge():
    """STORED n = 2 on all-positive charges, B-spline; 5% gate."""
    e, ej, f = _energies(("charge", False, 2.0, "STORED", True), "BSPLINE",
                         lig_q=POSITIVE_Q[1])
    _check(e, ej, f, pairwise_energy("charge", *POSITIVE_Q[::-1]),
           GATE_INVPOWER, JAX_RTOL, "STORED n=2")


def test_stored_invpower_nm12_ljr_triquintic():
    """STORED n = -12 on the LJ repulsion, triquintic; 5% gate."""
    e, ej, f = _energies(("ljr", True, -12.0, "STORED"), "TRIQUINTIC")
    _check(e, ej, f, pairwise_energy("ljr"), GATE_INVPOWER, JAX_RTOL,
           "STORED n=-12")


def test_runtime_invpower_n2_charge_bspline():
    """RUNTIME n = 2: raw values generated with mode NONE, the mode
    flipped afterwards (as in the JAX test); 5% gate."""
    e, ej, f = _energies(("charge", False, 0.0, "NONE", True), "BSPLINE",
                         lig_q=POSITIVE_Q[1], runtime=2.0)
    _check(e, ej, f, pairwise_energy("charge", *POSITIVE_Q[::-1]),
           GATE_INVPOWER, JAX_RTOL, "RUNTIME n=2")


@pytest.fixture(scope="module")
def tiled_files(tmp_path_factory):
    """The ljr grid written straight to OMGTILE files by both packages,
    without and with derivatives: {(package, derivatives): path}."""
    root = tmp_path_factory.mktemp("tiled")
    out = {}
    for derivs in (False, True):
        for pkg, gen, dtype in (("port", gridgen, torch.float64),
                                ("jax", jgridgen, np.float64)):
            path = str(root / f"{pkg}_{int(derivs)}.tiled")
            kw = {"device": "cpu"} if pkg == "port" else {}
            gen.generate_grid_to_tiled_file(
                path, COUNTS, SPACING, ORIGIN, "ljr", REC_POS, REC_Q,
                REC_SIG, REC_EPS, tile_size=16, compute_derivatives=derivs,
                dtype=dtype, **kw)
            out[pkg, derivs] = path
    return out


@pytest.mark.parametrize("method", METHODS)
def test_tiled_grid_vs_pairwise(tiled_files, method):
    """Tiled copies: generated to an OMGTILE file, stream-evaluated in
    float32 through each package's StreamedGridEvaluator."""
    derivs = method in HERMITE
    s = scaling("ljr").astype(np.float32)
    x = LIG_POS.astype(np.float32)
    ev = StreamedGridEvaluator(tiled_files["port", derivs],
                               interp_method=InterpolationMethod[method],
                               region_shape=(32, 32, 32), device="cpu")
    jev = JStreamedGridEvaluator(tiled_files["jax", derivs],
                                 interp_method=JMethod[method],
                                 region_shape=(32, 32, 32))
    got = ev.evaluate(x, s)
    want = jev.evaluate(x, s)
    _check(float(got.energy), float(want.energy), got.forces.numpy(),
           pairwise_energy("ljr"), GATE, JAX_RTOL_TILED, f"tiled {method}")
