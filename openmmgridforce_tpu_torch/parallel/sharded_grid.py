"""Packed grids split over ranks along x-cells, and MD on them.

The counterpart of the JAX package's ``parallel/sharded_grid.py``. The
packed per-cell table [ncells, K] is split along the x-cell axis over the
mesh axis ``sp``: rank i keeps the rows of cells [i*slab, (i+1)*slab),
slab = ceil(ncx / n), the last ranks padded with zero rows (padding cells
are never addressed: cell indices are clamped to real cells first).
Every rank evaluates all atoms against its own rows, counting only the
atoms whose cell it holds (the restraint of atoms outside the box on the
first rank only), and one ``all_reduce(SUM)`` of per-atom energies and
forces over sp ends the evaluation. Every other rank adds exact zeros,
so the result equals the unsharded evaluator's bit for bit.

A ``ShardedPackedGrid`` carries its mesh and axis, so it is a grid like
any other to ``mm/system.py``: ``energy_and_forces``, ``make_md_runner``
and the sampler evaluate it through ``evaluate_sharded``.

Packing folds each cell's interpolation stencil into its own row, so
evaluation needs no halo. Packing does: the cells [c0, c1) of a value
pack read the grid's x-points c0-1 .. c1+2 (B-spline) or c0 .. c1, and a
derivative pack's read c0 .. c1. ``pack_sharded`` packs a rank's cells
straight from its generation slab (``sharded_gridgen``) and those few
x-planes, sent by the ranks that hold them, so the whole grid never sits
on one device.

With a ("dp", "sp") mesh, replicas split over dp while the table splits
over sp; the all-reduce stays inside each sp group.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.cuda_packed_eval import packed_eval
from ..ops.interpolate import (HERMITE_FAMILIES, GridEval,
                                grid_back_power)
from ..ops.packed import (_DEGREES, _HERMITE_METHODS, HermitePackedGrid,
                          MultiHermitePackedGrid, MultiPackedGrid,
                          _default_basis, _FusedCells, _finish_multi,
                          _gather_window, _hermite_tensor_eval, _inputs,
                          _pack_cells, points_read)
from .mesh import Mesh
from .sharded_gridgen import slab_rows


@dataclasses.dataclass(frozen=True)
class ShardedPackedGrid(_FusedCells):
    """This rank's rows of a packed (possibly fused) table split over sp.

    ``coeffs`` holds the rows of this rank's ``ncx_padded / n`` x-cells;
    ``n_grids`` > 1 carries a fused table (one gather serves all fused
    grids per atom). ``form`` is "monomial" (rows of polynomial
    coefficients in ``poly_basis``) or "hermite" (corner-derivative rows
    of ``method``). ``mesh`` and ``axis`` name the ranks the table is
    split over; every rank of the axis evaluates it together.
    """

    coeffs: torch.Tensor          # [slab * ncy * ncz, K_row]
    spacing: torch.Tensor
    origin: torch.Tensor
    counts: tuple = (0, 0, 0)
    degree: int = 2
    n_grids: int = 1
    back_powers: tuple = (0.0,)
    oob_k: float = 0.0
    ncx_padded: int = 0
    form: str = "monomial"
    method: int = 0
    poly_basis: str = "monomial"
    mesh: Mesh = dataclasses.field(default=None, compare=False, repr=False)
    axis: str = "sp"

    @property
    def recordable(self) -> bool:
        """Whether a step that evaluates the table can be recorded as a
        CUDA graph: its all-reduce is NCCL's, or the axis has one rank.
        A gloo all-reduce goes through the host, so such steps run
        eagerly."""
        return not (self.mesh.host_staged and self.mesh.size(self.axis) > 1)


def _slab_cells(ncx: int, n: int, i: int) -> tuple:
    """(slab, c0, c1): rank i's cells [c0, c1) of ``ncx``, slab = ceil(ncx
    / n) rows of which c1 - c0 are real."""
    slab = -(-ncx // n)
    return slab, min(i * slab, ncx), min((i + 1) * slab, ncx)


def shard_packed_grid(packed, mesh: Mesh, axis: str = "sp"
                      ) -> ShardedPackedGrid:
    """This rank's rows of a PackedGrid, MultiPackedGrid, HermitePackedGrid
    or MultiHermitePackedGrid split along x-cells over ``axis``, on the
    mesh's device, zero-padded to ``ncx_padded / n`` cells."""
    form, method, degree = "monomial", 0, getattr(packed, "degree", 0)
    poly_basis = getattr(packed, "poly_basis", "monomial")
    if isinstance(packed, (HermitePackedGrid, MultiHermitePackedGrid)):
        form, method, degree = "hermite", packed.method, 0
    if isinstance(packed, (MultiPackedGrid, MultiHermitePackedGrid)):
        n_grids, back_powers = packed.n_grids, packed.back_powers
    else:
        n_grids, back_powers = 1, (packed.back_power,)
    n = mesh.size(axis)
    ncx, ncy, ncz = packed.cell_counts
    slab, c0, c1 = _slab_cells(ncx, n, mesh.index(axis))
    plane = ncy * ncz
    coeffs = torch.zeros((slab * plane, packed.coeffs.shape[-1]),
                         dtype=packed.coeffs.dtype, device=mesh.device)
    coeffs[:(c1 - c0) * plane] = packed.coeffs[c0 * plane:c1 * plane]
    return ShardedPackedGrid(
        coeffs=coeffs, spacing=packed.spacing.to(mesh.device),
        origin=packed.origin.to(mesh.device), counts=tuple(packed.counts),
        degree=degree, n_grids=n_grids, back_powers=tuple(back_powers),
        oob_k=packed.oob_k, ncx_padded=slab * n, form=form, method=method,
        poly_basis=poly_basis, mesh=mesh, axis=axis)


def _halo_window(slab, part, mesh: Mesh, lo: int, hi: int):
    """The grid's x-points [lo, hi) of ``part`` (``vals`` or ``derivs``):
    this rank's own rows, and those of its peers, which send them. Every
    rank of the axis calls this together."""
    axis = slab.axis
    n, me = mesh.size(axis), mesh.index(axis)
    nx = slab.counts[0]
    own = getattr(slab, part)
    x0, x1 = slab.x_range
    cells = slab.counts[0] - 1
    sends, recvs, pieces = {}, {}, {}
    for j in range(n):
        if j == me:
            continue
        g0, g1 = slab_rows(nx, n, j)
        # what peer j needs of my rows
        _, d0, d1 = _slab_cells(cells, n, j)
        if d1 > d0:
            w0, w1 = points_read(slab.interp_method, d0, d1, nx)
            a, b = max(w0, x0), min(w1, x1)
            if b > a:
                sends[j] = own[a - x0:b - x0]
        # what I need of peer j's rows
        a, b = max(lo, g0), min(hi, g1)
        if b > a:
            recvs[j] = own.new_empty((b - a,) + tuple(own.shape[1:]))
            pieces[a] = recvs[j]
    mesh.exchange(sends, recvs, axis)
    a, b = max(lo, x0), min(hi, x1)
    if b > a:
        pieces[a] = own[a - x0:b - x0]
    return torch.cat([pieces[k] for k in sorted(pieces)]) if pieces else \
        own[:0]


def pack_sharded(slabs, *, x_chunk: int | None = None
                 ) -> ShardedPackedGrid:
    """Pack this rank's x-cells of co-located grids of one method straight
    from their generation slabs (``sharded_gridgen.GridSlab``, one mesh
    axis), fused into one table in the slabs' dtype as
    ``ops/packed.pack_grids_fused`` would. The planes of the halo come
    from the ranks that generated them; the rows equal the single-device
    pack's rows of these cells. A collective over the slabs' axis.
    ``x_chunk`` cells are packed at a time (default: all of this
    rank's)."""
    first = slabs[0]
    mesh, axis = first.mesh, first.axis
    method = int(first.interp_method)
    nx, ny, nz = first.counts
    n, me = mesh.size(axis), mesh.index(axis)
    slab, c0, c1 = _slab_cells(nx - 1, n, me)
    dtype, device = first.vals.dtype, first.vals.device
    K = _DEGREES[method] ** 3
    poly_basis = _default_basis(method, dtype)
    lo, hi = points_read(method, c0, c1, nx) if c1 > c0 else (c0, c0)
    part = "derivs" if method in _HERMITE_METHODS else "vals"
    plane = (ny - 1) * (nz - 1)
    out = torch.zeros((slab * plane, len(slabs) * K), dtype=dtype,
                      device=device)
    step = max(1, x_chunk or slab)
    for gi, s in enumerate(slabs):
        if (s.axis, s.counts, int(s.interp_method)) != (
                axis, first.counts, method):
            raise ValueError("fused slabs must share their axis, counts "
                             "and interpolation method")
        window = _halo_window(s, part, mesh, lo, hi)
        local = dataclasses.replace(s, **{part: window})
        for a in range(c0, c1, step):
            b = min(a + step, c1)
            out[(a - c0) * plane:(b - c0) * plane, gi * K:(gi + 1) * K] = \
                _pack_cells(local, a, b, dtype, poly_basis, device, first=lo)
    return ShardedPackedGrid(
        coeffs=out, spacing=first.spacing.to(dtype),
        origin=first.origin.to(dtype), counts=tuple(first.counts),
        degree=_DEGREES[method], n_grids=len(slabs),
        back_powers=tuple(grid_back_power(s) for s in slabs),
        oob_k=first.oob_k, ncx_padded=slab * n, poly_basis=poly_basis,
        mesh=mesh, axis=axis)


def _eval_local_slab(grid: ShardedPackedGrid, positions, scaling,
                     mesh: Mesh, axis: str) -> GridEval:
    positions, scaling = _inputs(grid, positions, scaling)
    if scaling.dim() == 1:
        scaling = scaling[None]
    slab = grid.ncx_padded // mesh.size(axis)
    me = mesh.index(axis)
    if grid.form != "hermite":
        per_atom, forces = packed_eval(grid, positions, scaling,
                                       x_lo=me * slab, x_count=slab,
                                       restrain=me == 0)
        return _all_reduce(per_atom, forces, mesh, axis)
    pos, corner, inside, owned, f, rows = _gather_window(
        grid, positions, me * slab, slab)
    X = rows.reshape(rows.shape[:-1] + (grid.n_grids, 8, -1))
    interp, grad_s = _hermite_tensor_eval(X, f,
                                          *HERMITE_FAMILIES[grid.method])
    res = _finish_multi(interp, grad_s, grid.back_powers, grid.spacing,
                        scaling, pos, corner, inside, grid.oob_k,
                        owned=owned, restrain=me == 0)
    return _all_reduce(res.per_atom_energy, res.forces, mesh, axis)


def _all_reduce(per_atom, forces, mesh: Mesh, axis: str) -> GridEval:
    """The ranks' per-atom energies and forces summed over ``axis``."""
    both = torch.cat([per_atom[..., None], forces], dim=-1)
    mesh.all_reduce(both, axis)
    # contiguous: the energy sums the atoms in the unsharded order
    per_atom = both[..., 0].contiguous()
    return GridEval(per_atom.sum(-1), both[..., 1:], per_atom)


def evaluate_sharded(grid: ShardedPackedGrid, positions,
                     scaling) -> GridEval:
    """The table's energy and forces over its mesh axis: a collective
    (one all-reduce), every rank of the axis calling it with the same
    positions [..., N, 3]; scaling is [N] or [G, N]."""
    return _eval_local_slab(grid, positions, scaling, grid.mesh, grid.axis)


def make_sharded_grid_eval(mesh: Mesh, axis: str = "sp"):
    """``eval_fn(sharded_grid, positions [..., N, 3], scaling) -> GridEval``
    over ``axis``; scaling is [N] or [G, N]. Every rank of the axis calls
    it with the same positions (one all-reduce)."""
    def eval_fn(grid: ShardedPackedGrid, positions, scaling) -> GridEval:
        return _eval_local_slab(grid, positions, scaling, mesh, axis)

    return eval_fn


def make_sharded_md_runner(mesh: Mesh, n_steps: int, dt: float,
                           friction: float, dp_axis: str = "dp",
                           sp_axis: str = "sp", constraints=None):
    """Classic Langevin MD over a (dp x sp) mesh: ``mm/system.py``'s
    ``make_md_runner`` on this rank's replicas with the sharded table as
    its one grid, and the ensemble's noise drawn independently of the
    layout.

    Replicas split over ``dp_axis``; the table splits over ``sp_axis`` (one
    all-reduce per force evaluation). Bonded, pair and constraint terms
    are rank-local. ``constraints``: an optional ConstraintSet, which
    takes the place of the system's (None: unconstrained, as in the JAX
    package).

    Returns ``run(states, system, sharded_grid, scaling, temperatures,
    noise=None)``: ``states`` this rank's rows [R_local, N, 3],
    ``temperatures`` a number or this rank's rows [R_local], ``scaling``
    [N] or [G, N]. ``noise`` None draws the ensemble's noise from the
    states' generator (seeded alike on every rank) with
    ``replicas.replica_noise``, as a one-rank ``make_md_runner`` on the
    same device draws it, so trajectories do not depend on the layout.
    Or pass this rank's rows [n_steps, R_local, N, 3].

    ``run.mode`` follows from the device and backend: "recorded" on the
    card when the step issues no host-staged collective (NCCL, whose
    all-reduce is recorded inside the CUDA graphs of
    ``mm/graphs.Segment``, or an sp axis of one rank), else "eager" (gloo
    all-reduces through the host: the segment's blocks run under
    ``graphs.eager()``; on the host every run is a plain loop). A failed
    recording raises.
    """
    from ..mm.system import GridBinding, make_md_runner
    from .replicas import replica_noise

    md = make_md_runner(n_steps, dt, friction, device=mesh.device)
    on_card = mesh.device.type == "cuda"
    systems = {}

    def constrained(system):
        # one System with ``constraints`` per system, kept, so that the
        # runner's recording is found again on the next run
        if system.constraints is constraints:
            return system
        hit = systems.get(id(system))
        if hit is None or hit[0] is not system:
            systems.clear()
            hit = systems[id(system)] = (system, dataclasses.replace(
                system, constraints=constraints))
        return hit[1]

    def run(states, system, sharded_grid, scaling, temperatures,
            noise=None):
        if sharded_grid.mesh is not mesh or sharded_grid.axis != sp_axis:
            raise ValueError("the table is split over another mesh or "
                             "axis than the runner's")
        x = states.positions
        if noise is None:
            noise = replica_noise(states.generator, n_steps, x.shape,
                                  x.dtype, mesh, dp_axis, blocks=on_card)
        return md(states, constrained(system),
                  [GridBinding(grid=sharded_grid, scaling=scaling)],
                  temperatures, noise=noise)

    recordable = not (mesh.host_staged and mesh.size(sp_axis) > 1)
    run.mode = "recorded" if on_card and recordable else "eager"
    return run
