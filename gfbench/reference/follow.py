"""The reference's runs of the two kinds of traffic, and the numbers that
judge the program by them.

``follow`` runs Langevin steps of sampled replicas from a state the program
reached, with the same noise. ``grid_gaps`` compares a packed table the
program made with the reference's own grids at sampled points.
"""

from __future__ import annotations

import torch

from . import fields, interp


def follow(model, field, x0, v0, noise, dt, friction, temperature):
    """Positions and velocities after ``noise.shape[0]`` steps from (x0,
    v0) [M, N, 3] with per-step noise [S, M, N, 3]."""
    dt_ = model.ar.dtype
    x, v = x0.to(dt_), v0.to(dt_)
    for s in range(noise.shape[0]):
        f = model.forces(x, field.energy)
        x, v = model.langevin(x, v, f, noise[s].to(dt_), dt, friction,
                              temperature)
    return x, v


def replica_gaps(x, v, x_ref, v_ref):
    """Each replica's widest atom distance [M] between two states [M, N, 3]
    of positions (nm) and of velocities (nm/ps)."""
    return ((x.double() - x_ref.double()).norm(dim=-1).amax(-1),
            (v.double() - v_ref.double()).norm(dim=-1).amax(-1))


def reference_at_points(kind, points, box, grid_types, receptor, cap, ar):
    """The reference grids' values [P, G] and fraction-gradients
    [P, G, 3] at points [P, 3] inside the box (counts, origin, spacing)."""
    counts, origin, spacing = box
    _, cell, frac = interp.locate(points.to(ar.dtype), origin, spacing,
                                  counts)
    if kind == "values":
        pts = interp.bspline_points(cell, counts)
    else:
        pts = interp.corner_points(cell, counts)
    flat, inverse = torch.unique(pts.reshape(-1), return_inverse=True)
    data = fields.grid_data(kind, flat, counts, origin, spacing, grid_types,
                            receptor, cap, ar)[inverse.reshape(pts.shape)]
    if kind == "values":
        vals = data.movedim(-1, -4)
        return interp.value_and_gradient(
            lambda f: interp.bspline_value(vals, f, ar), frac)
    D = data.movedim(-4, -7)
    return interp.value_and_gradient(
        lambda f: interp.hermite_value(D, f, ar), frac)


def table_at_points(table, points, box):
    """A packed table's values [P, G] and fraction-gradients [P, G, 3] at
    points [P, 3] inside its box, read in float64. ``table`` has the
    attributes of the program's fused tables: coeffs [cells, G d^3],
    degree, n_grids, poly_basis."""
    counts, origin, spacing = box
    _, cell, frac = interp.locate(points.double(), origin, spacing, counts)
    return interp.value_and_gradient(
        lambda f: interp.table_value(table.coeffs, table.degree,
                                     table.n_grids, table.poly_basis,
                                     counts, cell, f), frac.double())


def grid_gaps(got, want):
    """Widest gap of values and of gradients, each grid's measured against
    that grid's widest reference value or gradient: (value, gradient)."""
    v, g = (a.double() for a in got)
    vr, gr = (a.double() for a in want)
    value = ((v - vr).abs().amax(0) / vr.abs().amax(0)).max()
    grad = ((g - gr).norm(dim=-1).amax(0)
            / gr.norm(dim=-1).amax(0)).max()
    return float(value), float(grad)
