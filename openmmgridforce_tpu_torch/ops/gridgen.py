"""Grid generation: receptor fields sampled on a rectilinear grid.

Two pipelines, in the JAX module's order of operations:

  values only:  sum the fields of all receptor atoms at every grid point
                -> tanh cap -> inverse-power storage transform when one is
                configured (for any mode but NONE);
  derivatives:  sum the 27 Cartesian derivatives -> exact tanh chain rule
                -> inverse-power chain rule if STORED -> scale to
                cell-fractional units. ``vals`` is then slot 0 of
                ``derivs``; it differs from the values-only path below
                0.1 cap (the chain rule's passthrough) and in the clamp.

The device decides the route. A CUDA run (float32 or float64) goes through
the hand-written kernels: ``ops/cuda_gridgen.py`` for values,
``ops/cuda_gridgen_derivs.py`` for the raw derivative sums, followed by the
per-point chain rules here. A CPU run takes the same route with each
kernel's plain twin in the kernel's place.

``generate_grid_to_tiled_file`` writes a grid too large for memory into an
OMGTILE file: one launch per x-slab of tiles (split along y when a slab
with derivatives would pass a memory budget), each slab's points formed
from their global index, so the file holds exactly the grid that
``generate_grid`` returns.

Clamps: r >= 1e-6 nm for values, r^2 >= 4e-4 nm^2 for derivatives.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..grid import Grid, InterpolationMethod, InvPowerMode
from ..units import DEFAULT_GRID_CAP, DEFAULT_OOB_K, TWO_POW_ONE_SIXTH
from ..utils.observe import trace
from . import radial
from .chain_rules import apply_invpower, apply_tanh_cap, tanh_cap_value
from .cuda_gridgen import grid_point_positions, gridgen_values  # noqa: F401
from .cuda_gridgen_derivs import gridgen_derivs
from .derivatives27 import N_DERIVS, spacing_scale_factors

_R_MIN_VALUES = 1e-6      # nm
_POST_POINT_CHUNK = 1 << 18   # points per pass of the chain rules


def _values_at_points(points, grid_type, positions, charges, sigmas,
                      epsilons, grid_cap, lj_convention="rmin"):
    """Capped field values at points [..., 3] from the field laws
    (receptor arrays [A]); the [..., A] pair block is materialised, so
    callers chunk the points."""
    dr = points[..., None, :] - positions          # [..., A, 3]
    r = torch.sqrt((dr * dr).sum(-1)).clamp_min(_R_MIN_VALUES)
    contrib = radial.field_value(r, grid_type, charges, sigmas, epsilons,
                                 lj_convention)
    return tanh_cap_value(contrib.sum(-1), grid_cap)


def _postprocess_raw_derivs(raw, *, grid_cap, inv_power, inv_power_mode,
                            spacing, point_chunk: int = _POST_POINT_CHUNK):
    """Cap, transform and scale raw 27-derivative sums [..., 27]: the
    per-point tail of derivative generation. Runs in chunks of points so
    the Faa di Bruno temporaries stay small beside a full grid. The
    chain rules are the span ``omgf.gridgen.chain_rules``; the upload of
    the scale factors before them, which waits for the card, is its own."""
    with trace("omgf.sync.derivative_scale"):
        scale = torch.as_tensor(spacing_scale_factors(spacing),
                                dtype=raw.dtype, device=raw.device)
    with trace("omgf.gridgen.chain_rules"):
        flat = raw.reshape(-1, raw.shape[-1])
        out = torch.empty_like(flat)
        for lo in range(0, flat.shape[0], point_chunk):
            V = apply_tanh_cap(flat[lo:lo + point_chunk], grid_cap)
            if inv_power != 0.0 and inv_power_mode == InvPowerMode.STORED:
                V = apply_invpower(V, 1.0 / inv_power)
            out[lo:lo + point_chunk] = V * scale
        return out.reshape(raw.shape)


def _store_transform(vals, inv_power, inv_power_mode):
    """The values-only inverse-power storage transform, for any mode but
    NONE (no 1e-10 dead zone on this side)."""
    if inv_power != 0.0 and inv_power_mode != InvPowerMode.NONE:
        sign = torch.where(vals >= 0.0, 1.0, -1.0).to(vals.dtype)
        vals = sign * vals.abs() ** (1.0 / inv_power)
    return vals


def _check_dtype(dtype):
    """Generation runs in float32 or float64 (the kernels' two
    instantiations, and their twins); refused before the device is
    touched."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"grid generation takes float32 or float64, got "
                         f"{dtype}")


# Device bytes of one generate_grid call, per grid point and byte of its
# dtype: the larger of the JAX package's factor (its full grid, the
# 27-derivative array and one staging copy: 28 + 27 with derivatives, 2
# for values) and the peak measured on the card over the bench box
# (chip_smoke.py's memory_guard line: 4.0-4.3 for values with a stored
# inverse power, 70.9-71.5 with derivatives: the raw sums, the output and
# the chain rules' temporaries of a 2^18-point chunk), rounded up. The
# guard refuses a request whose bytes pass the budget before anything is
# allocated or launched.
GUARD_FACTOR_VALUES = 5
GUARD_FACTOR_DERIVS = 75


def _device_memory_budget(device):
    """Usable device memory in bytes, or None when unbounded.

    The reference mitigates generation OOM proactively (skips derivatives
    above 80% free GPU memory, CudaGridForceKernels.cpp:527-535); here the
    same check turns a certain device OOM into an actionable error
    pointing at the tiled path. On CUDA the budget is 0.8 of what PyTorch
    can still use: the card's free bytes and the caching allocator's
    reserved-but-unallocated bytes. The host is unbounded.
    """
    device = torch.device(device)
    if device.type != "cuda":
        return None
    with trace("omgf.sync.memory_guard"):
        free, _ = torch.cuda.mem_get_info(device)
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
    return int(0.8 * (free + cached))


def _check_grid_fits(total_points, compute_derivatives, itemsize, device):
    budget = _device_memory_budget(device)
    if budget is None:
        return
    factor = (GUARD_FACTOR_DERIVS if compute_derivatives
              else GUARD_FACTOR_VALUES)
    need = total_points * itemsize * factor
    if need > budget:
        what = " with 27 derivatives" if compute_derivatives else ""
        raise ValueError(
            f"grid of {total_points:,} points{what} needs ~{need/1e9:.1f} "
            f"GB on device (>{budget/1e9:.1f} GB available); use "
            "generate_grid_to_tiled_file + StreamedGridEvaluator for "
            "out-of-core grids, or drop compute_derivatives "
            "(B-spline/trilinear do not need them)")


def receptor_atoms(grid_type, positions, charges, sigmas, epsilons,
                   lj_convention="rmin", dtype=torch.float32, device=None):
    """The kernel's atom table [A, 4]: rows (x, y, z, K), K the per-atom
    field strength computed on the host in float64."""
    pos = np.asarray(positions, np.float64).reshape(-1, 3)
    K = radial.field_strength(grid_type, charges, sigmas, epsilons,
                              lj_convention)
    table = np.concatenate([pos, K[:, None]], axis=1)
    device = resolve_device(device)
    with trace("omgf.sync.atoms"):
        return torch.as_tensor(table, dtype=dtype,
                               device=device).contiguous()


def generate_grid(counts,
                  spacing,
                  origin,
                  grid_type: str,
                  receptor_positions,
                  charges,
                  sigmas,
                  epsilons,
                  *,
                  compute_derivatives: bool = False,
                  grid_cap: float = DEFAULT_GRID_CAP,
                  inv_power: float = 0.0,
                  inv_power_mode: InvPowerMode = InvPowerMode.NONE,
                  interp_method: InterpolationMethod =
                  InterpolationMethod.TRILINEAR,
                  oob_k: float = DEFAULT_OOB_K,
                  lj_convention: str = "rmin",
                  dtype=torch.float32,
                  device=None) -> Grid:
    """Generate one receptor grid, optionally with 27 analytic
    derivatives.

    The per-atom strength K of the chosen grid type and LJ convention is
    computed on the host in float64; the sum over atoms runs on ``device``
    (the CUDA card by default) in ``dtype``. With ``compute_derivatives``
    the grid carries ``derivs`` [nx, ny, nz, 27] in cell-fractional units
    and ``vals`` is their slot 0.

    A grid that cannot fit in the device's memory is refused with a
    ``ValueError`` before anything is allocated or launched; such grids
    go through :func:`generate_grid_to_tiled_file` and
    ``io.streaming.StreamedGridEvaluator``.

    The call is the span ``omgf.gridgen``; the chain rules of derivative
    grids the span ``omgf.gridgen.chain_rules``, and each upload that
    waits for the card an ``omgf.sync`` span.
    """
    with trace("omgf.gridgen"):
        _check_dtype(dtype)
        device = resolve_device(device)
        counts = tuple(int(c) for c in counts)
        _check_grid_fits(int(np.prod(counts)), compute_derivatives,
                         torch.empty((), dtype=dtype).element_size(), device)
        # the per-atom strength K carries the LJ convention, so one atom table
        # serves both conventions on either route
        atoms = receptor_atoms(grid_type, receptor_positions, charges, sigmas,
                               epsilons, lj_convention, dtype, device)
        derivs = None
        if compute_derivatives:
            raw = gridgen_derivs(atoms, counts, spacing, origin, grid_type)
            derivs = _postprocess_raw_derivs(
                raw, grid_cap=grid_cap, inv_power=inv_power,
                inv_power_mode=inv_power_mode, spacing=spacing)
            vals = derivs[..., 0]
        else:
            vals = _store_transform(
                gridgen_values(atoms, counts, spacing, origin, grid_type,
                               grid_cap), inv_power, inv_power_mode)
        with trace("omgf.sync.grid_geometry"):
            spacing = torch.tensor(spacing, dtype=dtype, device=device)
            origin = torch.tensor(origin, dtype=dtype, device=device)
        return Grid(
            vals=vals,
            derivs=derivs,
            spacing=spacing,
            origin=origin,
            counts=counts,
            interp_method=int(interp_method),
            inv_power_mode=int(inv_power_mode),
            inv_power=float(inv_power),
            grid_cap=float(grid_cap),
            oob_k=float(oob_k),
            grid_type=grid_type,
        )


def auto_scaling_factors(grid_type: str, charges, sigmas, epsilons,
                         convention: str = "rmin"):
    """Per-atom scaling factors (float64 numpy) for a grid type.

    ``convention``: "rmin" gives sqrt(eps) Rmin^k with Rmin = 2^(1/6)
    sigma, consistent with the generated fields; "diameter" gives
    sqrt(eps) (2 sigma)^k, the reference platform's form.
    """
    charges = np.asarray(charges, np.float64)
    sigmas = np.asarray(sigmas, np.float64)
    epsilons = np.asarray(epsilons, np.float64)
    if grid_type == "charge":
        return charges
    if convention == "rmin":
        d = TWO_POW_ONE_SIXTH * sigmas
    elif convention == "diameter":
        d = 2.0 * sigmas
    else:
        raise ValueError(f"unknown convention {convention!r}")
    if grid_type == "ljr":
        return np.sqrt(epsilons) * d ** 6
    if grid_type == "lja":
        return np.sqrt(epsilons) * d ** 3
    raise ValueError(f"unknown grid type {grid_type!r}")


# device bytes a slab with derivatives may take (raw sums and chain rules)
SLAB_BUDGET_BYTES = 1 << 30


def generate_grid_to_tiled_file(path,
                                counts,
                                spacing,
                                origin,
                                grid_type: str,
                                receptor_positions,
                                charges,
                                sigmas,
                                epsilons,
                                *,
                                tile_size: int = 32,
                                compute_derivatives: bool = False,
                                grid_cap: float = DEFAULT_GRID_CAP,
                                inv_power: float = 0.0,
                                inv_power_mode: InvPowerMode =
                                InvPowerMode.NONE,
                                dtype=torch.float32,
                                progress=None,
                                device=None,
                                slab_budget_bytes: int =
                                SLAB_BUDGET_BYTES) -> None:
    """Generate a grid directly into an OMGTILE file.

    The counterpart of the JAX package's function of the same name (and
    of the reference's generateGridToTiledFile): the grid never exists
    whole, in device or host memory. Each launch of the values kernel (or
    of the derivative kernel and the chain rules) covers an x-slab of
    tiles, all of y and z, at the index offset of its first point; with
    derivatives a slab is cut along y into runs of tile rows that fit
    ``slab_budget_bytes``. Slabs are copied into two pinned host buffers
    in turn, so the next slab's kernel runs while the tiles of the last
    are written, in the writer's order (x, then y, then z tiles). Values
    are stored in float32 whatever ``dtype`` computes them.

    ``progress``: optional callback(tiles_done, total_tiles).
    """
    from ..io.omgtile import TiledGridWriter, num_tiles

    _check_dtype(dtype)
    device = resolve_device(device)
    counts = tuple(int(c) for c in counts)
    nx, ny, nz = counts
    ts = int(tile_size)
    atoms = receptor_atoms(grid_type, receptor_positions, charges, sigmas,
                           epsilons, "rmin", dtype, device)
    ntx, nty, ntz = num_tiles(counts, ts)
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_point = itemsize * 2 * N_DERIVS if compute_derivatives else itemsize
    rows = max(1, min(nty, slab_budget_bytes // (per_point * ts * ts * nz)))
    slabs = [(tx, ty0, min(ty0 + rows, nty)) for tx in range(ntx)
             for ty0 in range(0, nty, rows)]
    cuda = device.type == "cuda"
    if cuda:
        largest = min(ts, nx) * min(rows * ts, ny) * nz * (
            N_DERIVS if compute_derivatives else 1)
        buffers = [torch.empty(largest, dtype=torch.float32,
                               pin_memory=True) for _ in range(2)]

    def compute(slab, n):
        tx, ta, tb = slab
        x0, y0 = tx * ts, ta * ts
        shape = (min(x0 + ts, nx) - x0, min(tb * ts, ny) - y0, nz)
        if compute_derivatives:
            raw = gridgen_derivs(atoms, shape, spacing, origin, grid_type,
                                 index_offset=(x0, y0, 0))
            out = _postprocess_raw_derivs(
                raw, grid_cap=grid_cap, inv_power=inv_power,
                inv_power_mode=inv_power_mode, spacing=spacing)
        else:
            out = _store_transform(
                gridgen_values(atoms, shape, spacing, origin, grid_type,
                               grid_cap, index_offset=(x0, y0, 0)),
                inv_power, inv_power_mode)
        out = out.to(torch.float32)
        if not cuda:
            return out.numpy(), None
        host = buffers[n % 2][:out.numel()].view(out.shape)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host.numpy(), done

    total = ntx * nty * ntz
    written = 0

    def write(slab, arr):
        nonlocal written
        tx, ta, tb = slab
        for ty in range(ta, tb):
            y0 = (ty - ta) * ts
            y1 = min(y0 + ts, arr.shape[1])
            for tz in range(ntz):
                tile = arr[:, y0:y1, tz * ts:min((tz + 1) * ts, nz)]
                if compute_derivatives:
                    writer.write_tile(tx, ty, tz, tile[..., 0],
                                      np.moveaxis(tile, -1, 0))
                else:
                    writer.write_tile(tx, ty, tz, tile)
                written += 1
                if progress is not None:
                    progress(written, total)

    with TiledGridWriter(path, counts, spacing, origin, tile_size=ts,
                         has_derivatives=compute_derivatives,
                         inv_power=inv_power,
                         inv_power_mode=int(inv_power_mode)) as writer:
        pending = None
        for n, slab in enumerate(slabs):
            arr, done = compute(slab, n)
            if pending is not None:
                write(*pending)
            if done is not None:
                done.synchronize()
            pending = (slab, arr)
        if pending is not None:
            write(*pending)
