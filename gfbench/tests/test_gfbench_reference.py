"""The plain reference against the program at a tiny size on the CPU,
through the program's CPU path, in float64 (where the two agree to
rounding), and the reference's own building blocks."""

import numpy as np
import pytest
import torch

from gfbench import complex as cx
from gfbench import program
from gfbench.reference import fields, interp
from gfbench.reference.follow import (follow, grid_gaps, reference_at_points,
                                      table_at_points)
from gfbench.reference.ligand import GridField, LigandModel
from gfbench.reference.precision import Arith, tf32

TYPES = ["charge", "ljr", "lja"]
CAP, OOB_K = 41840.0, 10000.0
COUNTS, SPACING = (31, 33, 31), 0.1


@pytest.fixture(scope="module")
def complex_():
    lig, rec = cx.synthetic_complex(7, 47, 300, 0.7, 0.1)
    box = (COUNTS, cx.grid_box(lig.coords, COUNTS, SPACING), (SPACING,) * 3)
    return lig, rec, box


def _config(method):
    return {"grids": {"types": TYPES, "cap": CAP, "oob_k": OOB_K,
                      "method": method},
            "md": {"hydrogen_mass": 4.0, "dt_ps": 0.001,
                   "friction_per_ps": 5.0}}


def _program_table(method, complex_, dtype):
    from openmmgridforce_tpu_torch.grid import InterpolationMethod
    from openmmgridforce_tpu_torch.ops.gridgen import generate_grid

    lig, rec, box = complex_
    grids = [generate_grid(box[0], box[2], box[1], gt, rec.coords,
                           rec.charges, rec.sigmas, rec.epsilons,
                           grid_cap=CAP, oob_k=OOB_K,
                           compute_derivatives=method == "triquintic",
                           interp_method=InterpolationMethod[
                               program.GRID_METHODS[method]],
                           dtype=dtype, device="cpu")
             for gt in TYPES]
    return program.pack(grids)


def _points(box, n=256, seed=0):
    counts, origin, spacing = box
    u = np.random.default_rng(seed).random((n, 3))
    return torch.as_tensor(np.asarray(origin) + u * np.asarray(spacing)
                           * (np.asarray(counts) - 1))


@pytest.mark.parametrize("method, kind, tol", [
    ("bspline", "values", 1e-12),
    # the program's float64 triquintic pack is monomial: its coefficients
    # grow to 1e8 near receptor cores, which costs some digits
    ("triquintic", "derivatives", 1e-7)])
def test_grids_match_the_program_in_float64(complex_, method, kind, tol):
    lig, rec, box = complex_
    table = _program_table(method, complex_, torch.float64)
    pts = _points(box)
    got = table_at_points(table, pts, box)
    want = reference_at_points(kind, pts, box, TYPES,
                               (rec.coords, rec.charges, rec.sigmas,
                                rec.epsilons), CAP, Arith("float64"))
    value, gradient = grid_gaps(got, want)
    assert value < tol and gradient < 10 * tol


def _positions(lig, box, n=6, seed=1, sd=0.02):
    """Poses near the ligand's own; the first moved whole past the box's
    upper x face and the second past its lower y face by 0.02 nm."""
    rng = np.random.default_rng(seed)
    x = lig.coords[None] + sd * rng.standard_normal((n, lig.natom, 3))
    hi = box[1][0] + SPACING * (box[0][0] - 1)
    x[0, :, 0] += hi + 0.02 - x[0, :, 0].max()
    x[1, :, 1] += box[1][1] - 0.02 - x[1, :, 1].min()
    return torch.as_tensor(x)


def _binding(table, scaling):
    from openmmgridforce_tpu_torch.mm import GridBinding

    return GridBinding(grid=table, scaling=torch.as_tensor(scaling))


@pytest.mark.parametrize("method, kind", [("bspline", "values"),
                                          ("triquintic", "derivatives")])
def test_forces_match_the_program_in_float64(complex_, method, kind):
    from openmmgridforce_tpu_torch.mm import energy_and_forces
    from openmmgridforce_tpu_torch.mm import system_from_amber

    lig, rec, box = complex_
    table = _program_table(method, complex_, torch.float64)
    scaling = np.stack([fields.scalings(gt, lig.charges, lig.sigmas,
                                        lig.epsilons) for gt in TYPES])
    binding = _binding(table, scaling)
    system = system_from_amber(program.topology(lig), dtype=torch.float64,
                               hydrogen_mass=4.0, device="cpu")
    x = _positions(lig, box)
    _, f_prog = energy_and_forces(system, [binding], x)

    ar = Arith("float64")
    model = LigandModel(lig, 4.0, ar, "cpu")
    field = GridField(kind, box[0], box[1], box[2], TYPES,
                      (rec.coords, rec.charges, rec.sigmas, rec.epsilons),
                      CAP, OOB_K, scaling, ar, "cpu")
    f_ref = model.forces(x, field.energy)
    scale = float(f_ref.abs().max())
    tol = 1e-12 if method == "bspline" else 1e-8
    assert float((f_prog - f_ref).abs().max()) < tol * scale
    np.testing.assert_allclose(model.masses.numpy(), system.masses.numpy(),
                               rtol=0, atol=1e-12)


def test_langevin_steps_match_the_program(complex_):
    from openmmgridforce_tpu_torch.mm import MDState, make_md_runner
    from openmmgridforce_tpu_torch.mm import system_from_amber

    lig, rec, box = complex_
    table = _program_table("bspline", complex_, torch.float64)
    scaling = np.stack([fields.scalings(gt, lig.charges, lig.sigmas,
                                        lig.epsilons) for gt in TYPES])
    binding = _binding(table, scaling)
    system = system_from_amber(program.topology(lig), dtype=torch.float64,
                               hydrogen_mass=4.0, device="cpu")
    # thermal velocities, near the ligand's own pose and outside the box
    x0 = _positions(lig, box, n=4, seed=2, sd=0.003)
    gen = torch.Generator().manual_seed(3)
    sd = torch.sqrt(0.00831446261815324 * 300.0 / system.masses)[:, None]
    v0 = sd * torch.randn(x0.shape, generator=gen, dtype=torch.float64)
    noise = torch.randn((20,) + x0.shape, generator=gen, dtype=torch.float64)
    run = make_md_runner(20, dt=0.001, friction=5.0, device="cpu")
    out = run(MDState(x0, v0, None), system, [binding], 300.0, noise=noise)

    ar = Arith("float64")
    model = LigandModel(lig, 4.0, ar, "cpu")
    field = GridField("values", box[0], box[1], box[2], TYPES,
                      (rec.coords, rec.charges, rec.sigmas, rec.epsilons),
                      CAP, OOB_K, scaling, ar, "cpu")
    x, v = follow(model, field, x0, v0, noise, 0.001, 5.0, 300.0)
    assert float((x - out.positions).abs().max()) < 1e-11
    assert float((v - out.velocities).abs().max()) < 1e-8


def test_tf32_rounds_to_ten_fraction_bits():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -12, one + 2 ** -11, one + 3 * 2 ** -12,
                      -(one + 2 ** -11), float("inf"), 0.0])
    want = torch.tensor([one, one, one + 2 ** -10, one + 2 ** -10,
                         -(one + 2 ** -10), float("inf"), 0.0])
    assert torch.equal(tf32(x), want)
    assert torch.equal(Arith("float64").rnd(x.double()), x.double())


def test_quintic_hermite_basis_meets_its_end_conditions():
    t = torch.tensor([0.0, 1.0], dtype=torch.float64, requires_grad=True)
    H = interp.hermite5_weights(t)                  # [2, 3, 2]
    for m in range(3):
        for side in range(2):
            h = H[:, m, side]
            d1 = torch.autograd.grad(h.sum(), t, create_graph=True)[0]
            d2 = torch.autograd.grad(d1.sum(), t, create_graph=True)[0]
            derivs = torch.stack([h, d1, d2])        # [order, end]
            want = torch.zeros(3, 2, dtype=torch.float64)
            want[m, side] = 1.0
            assert torch.allclose(derivs, want, atol=1e-12)


def test_bspline_weights_sum_to_one():
    f = torch.linspace(0, 1, 11, dtype=torch.float64)
    w = interp.bspline_weights(f)
    assert torch.allclose(w.sum(-1), torch.ones_like(f), atol=1e-15)
