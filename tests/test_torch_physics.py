"""NVE energy conservation on a generated grid, held by the port.

The JAX package's ``tests/test_physics.py`` through the port on the host,
float64: velocity Verlet (``make_verlet_step`` + ``run_segment``) for 3000
steps at 1 fs on the confining r^-12 shell's grid conserves the total
energy to 1e-5 relative and keeps every atom inside the box; analytic
forces that were not the exact gradient of the interpolated energy would
drift secularly. Besides the unpacked grids of the JAX test, the packed
route that ``chip_smoke.py``'s main and derivative paths step on: the
B-spline pack and the triquintic Chebyshev pack, through
``mm/system.py::_eval_grid``. The state after the first 300 steps equals
JAX's to 1e-10 nm; over the whole run the two may part through rounding
alone, so the drift gate is the check there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmgridforce_tpu import InterpolationMethod as JMethod
from openmmgridforce_tpu.mm import integrators as jintegrators
from openmmgridforce_tpu.mm.system import _eval_grid as j_eval_grid
from openmmgridforce_tpu.ops import gridgen as jgridgen
from openmmgridforce_tpu.ops.packed import pack_grid as jpack_grid
from openmmgridforce_tpu_torch.grid import InterpolationMethod
from openmmgridforce_tpu_torch.mm.integrators import (MDState,
                                                      make_verlet_step,
                                                      run_segment)
from openmmgridforce_tpu_torch.mm.system import _eval_grid
from openmmgridforce_tpu_torch.ops import gridgen
from openmmgridforce_tpu_torch.ops.packed import pack_grid

torch.set_num_threads(1)

COUNTS = (14, 14, 14)
SPACING = (0.08,) * 3
ORIGIN = (0.0, 0.0, 0.0)
N_ATOMS = 5
DT = 0.001
STEPS = 3000
JAX_STEPS = 300
DRIFT_GATE = 1e-5
JAX_ATOL = 1e-10               # nm and nm/ps, after JAX_STEPS


def _shell():
    """test_physics.py's confining field: r^-12 wall sources on a shell
    0.62 nm around the box centre (a Coulomb bowl has no stable interior
    minimum)."""
    center = np.full(3, 0.52)
    dirs = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for k in (-1, 0, 1) if (i, j, k) != (0, 0, 0)], float)
    src = center + 0.62 * dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    n = len(src)
    return src, np.zeros(n), np.full(n, 0.35), np.full(n, 0.5)


def _start():
    """test_physics.py's draws from default_rng(23): positions, then
    velocities."""
    rng = np.random.default_rng(23)
    x0 = rng.uniform(0.42, 0.62, (N_ATOMS, 3))
    return x0, 0.1 * rng.standard_normal((N_ATOMS, 3))


def _grids(method, packed):
    derivs = method == "TRIQUINTIC"
    basis = "chebyshev" if derivs else None
    g = gridgen.generate_grid(
        COUNTS, SPACING, ORIGIN, "ljr", *_shell(),
        compute_derivatives=derivs,
        interp_method=InterpolationMethod[method], dtype=torch.float64,
        device="cpu")
    jg = jgridgen.generate_grid(
        COUNTS, SPACING, ORIGIN, "ljr", *_shell(),
        compute_derivatives=derivs, interp_method=JMethod[method],
        dtype=jnp.float64)
    if packed:
        return pack_grid(g, poly_basis=basis), jpack_grid(jg,
                                                          poly_basis=basis)
    return g, jg


@pytest.mark.parametrize("packed", [False, True], ids=["grid", "pack"])
@pytest.mark.parametrize("method", ["BSPLINE", "TRIQUINTIC"])
def test_nve_energy_conservation_on_grid(method, packed):
    g, jg = _grids(method, packed)
    x0, v0 = _start()
    masses = torch.full((N_ATOMS,), 10.0, dtype=torch.float64)
    scaling = torch.full((N_ATOMS,), 1e-3, dtype=torch.float64)

    def total_energy(state):
        pe = float(_eval_grid(g, state.positions, scaling).energy)
        return pe + float(0.5 * (masses[:, None]
                                 * state.velocities ** 2).sum())

    step = make_verlet_step(lambda x: _eval_grid(g, x, scaling).forces,
                            masses, DT)
    state = MDState(torch.as_tensor(x0), torch.as_tensor(v0), None)
    e0 = total_energy(state)
    state = run_segment(step, state, JAX_STEPS)

    jscaling = jnp.full((N_ATOMS,), 1e-3)
    jstep = jintegrators.make_verlet_step(
        lambda x: j_eval_grid(jg, x, jscaling).forces,
        jnp.full((N_ATOMS,), 10.0), dt=DT)
    jstate = jax.jit(lambda s: jintegrators.run_segment(jstep, s, JAX_STEPS))(
        jintegrators.MDState(jnp.asarray(x0), jnp.asarray(v0),
                             jax.random.PRNGKey(0)))
    np.testing.assert_allclose(state.positions.numpy(),
                               np.asarray(jstate.positions), rtol=0,
                               atol=JAX_ATOL)
    np.testing.assert_allclose(state.velocities.numpy(),
                               np.asarray(jstate.velocities), rtol=0,
                               atol=JAX_ATOL)

    state = run_segment(step, state, STEPS - JAX_STEPS)
    e1 = total_energy(state)
    # all atoms must have stayed inside (the restraint branch is
    # discontinuous)
    corner = np.asarray(ORIGIN) + (np.asarray(COUNTS) - 1) * np.asarray(
        SPACING)
    x = state.positions.numpy()
    assert np.all((x >= np.asarray(ORIGIN)) & (x <= corner))
    assert abs(e1 - e0) / (abs(e0) + 1.0) < DRIFT_GATE, (e0, e1)


def test_shell_matches_chip_smoke():
    """chip_smoke.py's accuracy_path steps 1,000 replicas on the card from
    its own copy of this field and start: the two are the same."""
    import chip_smoke

    counts, spacing, origin, src, x0, v0 = chip_smoke.nve_shell(1000)
    assert (counts, spacing, origin) == (COUNTS, SPACING, ORIGIN)
    np.testing.assert_array_equal(src, _shell()[0])
    np.testing.assert_array_equal(x0, _start()[0])
    np.testing.assert_array_equal(v0[0], _start()[1])
