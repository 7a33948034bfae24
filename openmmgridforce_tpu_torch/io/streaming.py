"""Out-of-core grid evaluation over the native tile streamer.

The port of the JAX package's ``io/streaming.py`` (itself the counterpart
of the reference's tiled evaluation path, CudaGridForceKernels.cpp:888-975):
for grids too large for device memory, each evaluation streams one
fixed-size region covering the current atom cloud from the OMGTILE file
(through the native LRU tile cache) into a Grid on the device, then
evaluates it with the standard kernels: the port's packed evaluators for
packed regions, ``ops/interpolate.py::evaluate_grid`` for raw ones.

Positions may carry leading batch dimensions ([..., N, 3]) wherever the
JAX module vmapped: ``evaluate_batch`` evaluates each group of replicas
that share a region in one batched call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..grid import InterpolationMethod, grid_from_numpy
from ..ops.interpolate import GridEval, evaluate_grid
from ..ops.packed import PackedGrid, evaluate_packed
from ..units import DEFAULT_OOB_K
from .native import NativeTileStream

_HERMITE = (int(InterpolationMethod.TRICUBIC),
            int(InterpolationMethod.TRIQUINTIC))


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def evaluate_streamed(grid, full_origin, full_corner, positions,
                      scaling, oob_k: float, *,
                      return_gap_mask: bool = False):
    """Evaluate atoms [..., N, 3] on a region-resident grid, applying the
    out-of-bounds restraint of the FULL grid box.

    ``grid`` is a raw :class:`Grid` of the region (direct stencil) or a
    :class:`PackedGrid` of it (one row gather per atom, what MD steppers
    use). The region grid's own inside-test uses the region box; atoms
    outside the full grid are restrained toward the full box instead
    (reference semantics: the OOB branch is relative to the whole grid).
    Atoms inside the full grid but outside the region ("in the gap")
    would silently receive the region's restraint values; callers keep
    the cloud inside the region (``StreamedGridEvaluator.region_grid``).
    ``return_gap_mask=True`` returns ``(GridEval, gap_mask)`` with
    ``gap_mask[..., n]`` flagging exactly those atoms (active, inside the
    full box, outside the region's box).
    """
    if isinstance(grid, PackedGrid):
        res = evaluate_packed(grid, positions, scaling)
        dtype = grid.coeffs.dtype
    else:
        res = evaluate_grid(grid, positions, scaling)
        dtype = grid.vals.dtype
    positions = positions.to(dtype)
    dev = positions.device
    full_origin = torch.as_tensor(np.asarray(full_origin, np.float64),
                                  dtype=dtype, device=dev)
    full_corner = torch.as_tensor(np.asarray(full_corner, np.float64),
                                  dtype=dtype, device=dev)
    scaling = torch.as_tensor(scaling, dtype=dtype, device=dev)
    inside_full = ((positions >= full_origin)
                   & (positions <= full_corner)).all(-1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    d = torch.where(positions < full_origin, positions - full_origin,
                    torch.where(positions > full_corner,
                                positions - full_corner, zero))
    e_oob = 0.5 * oob_k * (d * d).sum(-1)
    f_oob = -oob_k * d
    active = inside_full & (scaling != 0.0)
    per_atom = torch.where(active, res.per_atom_energy, e_oob)
    forces = torch.where(active[..., None], res.forces, f_oob)
    out = GridEval(per_atom.sum(-1), forces, per_atom)
    if not return_gap_mask:
        return out
    region_origin = grid.origin.to(dtype)
    region_corner = region_origin + grid.spacing.to(dtype) * (
        torch.as_tensor(grid.counts, dtype=dtype, device=dev) - 1.0)
    inside_region = ((positions >= region_origin)
                     & (positions <= region_corner)).all(-1)
    return out, active & ~inside_region


# stencil halo (grid points) needed on each side per method
_HALO = {
    int(InterpolationMethod.TRILINEAR): (0, 1),
    int(InterpolationMethod.BSPLINE): (1, 2),
    int(InterpolationMethod.TRICUBIC): (0, 1),
    int(InterpolationMethod.TRIQUINTIC): (0, 1),
}


class StreamedGridEvaluator:
    """Evaluate atoms on a file-backed tiled grid, one region per call.

    Regions live on ``device`` (the CUDA card unless ``device="cpu"``) in
    ``dtype`` (the file's float32 unless given).
    """

    def __init__(self, path, interp_method=InterpolationMethod.TRILINEAR,
                 region_shape=(64, 64, 64), budget_bytes: int = 2 << 30,
                 inv_power_mode=None, inv_power=None,
                 oob_k: float = DEFAULT_OOB_K,
                 oob_convention: str = "reference", dtype=None,
                 device=None):
        """``oob_convention``: "reference" (default) applies the standard
        out-of-bounds restraint E = 1/2 k d^2, F = -k dev; "cuda-tiled"
        reproduces the reference's TILED kernel quirk Q7 (E = k d^2,
        F = -2 k dev, a doubled stiffness;
        platforms/cuda/src/kernels/gridForceTiled.cu:522-550)."""
        if oob_convention not in ("reference", "cuda-tiled"):
            raise ValueError(f"unknown oob_convention {oob_convention!r}")
        if oob_convention == "cuda-tiled":
            oob_k = 2.0 * oob_k
        self.oob_convention = oob_convention
        self.device = resolve_device(device)
        self.dtype = torch.float32 if dtype is None else dtype
        self.stream = NativeTileStream(path, budget_bytes)
        self.interp_method = int(interp_method)
        # never read beyond the grid: clamp the region per axis
        self.region_shape = tuple(
            min(int(r), int(c))
            for r, c in zip(region_shape, self.stream.counts))
        self.oob_k = oob_k
        self.inv_power_mode = (self.stream.inv_power_mode
                               if inv_power_mode is None
                               else int(inv_power_mode))
        self.inv_power = (self.stream.inv_power if inv_power is None
                          else float(inv_power))
        # last-region cache: (grid, (interior_lo, interior_hi)); reused
        # while the next call's cloud still fits the interior
        self._cached = None
        self._full_region = None
        self.region_hits = 0
        self.region_misses = 0
        # scattered-batch path: the device region LRU
        self._regions = {}
        self.device_regions = 8
        if self.interp_method in _HERMITE and not self.stream.has_derivatives:
            raise ValueError(
                "tiled file has no derivatives; Hermite methods need them")

    def _cell_bounds(self, positions):
        """Halo-inclusive (cell_lo, cell_hi) covering one cloud's in-grid
        atoms, or None when no atom is inside the full grid. Raises if the
        cloud cannot fit one region."""
        spacing = np.asarray(self.stream.spacing)
        origin = np.asarray(self.stream.origin)
        counts = np.asarray(self.stream.counts)
        lo_h, hi_h = _HALO[self.interp_method]

        pos = _numpy(positions)
        corner = origin + (counts - 1) * spacing
        inside = np.all((pos >= origin) & (pos <= corner), axis=1)
        if not np.any(inside):
            return None
        t = (pos[inside] - origin) / spacing
        cell_lo = np.clip(np.floor(t.min(axis=0)).astype(int) - lo_h,
                          0, counts - 1)
        cell_hi = np.clip(np.floor(t.max(axis=0)).astype(int) + 1 + hi_h,
                          0, counts - 1)
        need = cell_hi - cell_lo + 1
        if np.any(need > np.asarray(self.region_shape)):
            raise ValueError(
                f"atom cloud needs region {tuple(need)} > configured "
                f"{self.region_shape}; enlarge region_shape")
        return cell_lo, cell_hi

    @property
    def full_box(self):
        """(origin, corner) of the FULL on-disk grid in world coords."""
        spacing = np.asarray(self.stream.spacing)
        origin = np.asarray(self.stream.origin)
        corner = origin + (np.asarray(self.stream.counts) - 1) * spacing
        return origin, corner

    def _build_region(self, start, shape=None):
        """Read region ``start`` and return ``(grid, (ilo, ihi))``: a Grid
        on the device plus its exact interior box."""
        start = np.asarray(start, dtype=int)
        if shape is None:
            shape = self.region_shape
        vals, derivs = self.stream.read_region(
            start, shape, with_derivatives=self.interp_method in _HERMITE)
        spacing = np.asarray(self.stream.spacing)
        origin = np.asarray(self.stream.origin) + start * spacing
        grid = grid_from_numpy(
            vals, spacing, origin, derivs=derivs,
            interp_method=self.interp_method,
            inv_power_mode=self.inv_power_mode, inv_power=self.inv_power,
            oob_k=self.oob_k, dtype=self.dtype, device=self.device)
        return grid, self._interior_box(start, shape)

    def region_grid(self, positions):
        """The region covering ``positions`` [N, 3]: ``(grid,
        (interior_lo, interior_hi))``. Within the interior box,
        region-local evaluation is exact. Reuses the previous region (no
        file read) while every in-grid atom lies inside its interior."""
        if self._cached is not None:
            _, (ilo, ihi) = self._cached
            pos = _numpy(positions)
            full_lo, full_hi = self.full_box
            in_full = np.all((pos >= full_lo) & (pos <= full_hi), axis=1)
            if np.all(np.all((pos >= ilo) & (pos <= ihi), axis=1)
                      | ~in_full):
                self.region_hits += 1
                return self._cached
        self.region_misses += 1
        start = self._centered_region_for(positions)
        self._cached = self._build_region(start)
        return self._cached

    def _aligned_region_for(self, pos):
        """Region start for one cloud, aligned to a half-region lattice so
        nearby clouds share regions; the exact start when the cloud
        straddles a lattice boundary. Raises if no region can hold it."""
        cb = self._cell_bounds(pos)
        if cb is None:
            return np.zeros(3, dtype=int)
        cell_lo, cell_hi = cb
        counts = np.asarray(self.stream.counts)
        shape = np.asarray(self.region_shape)
        max_start = np.maximum(counts - shape, 0)
        stride = np.maximum(shape // 2, 1)
        aligned = np.clip((cell_lo // stride) * stride, 0, max_start)
        if np.all(cell_hi <= aligned + shape - 1):
            return aligned
        return np.clip(cell_lo, 0, max_start)

    def _centered_region_for(self, pos):
        """Region start centring one cloud: the symmetric margin sets how
        long a segment can run before the cloud reaches the interior
        boundary. Raises if the cloud cannot fit a region."""
        cb = self._cell_bounds(pos)
        if cb is None:
            return np.zeros(3, dtype=int)
        cell_lo, cell_hi = cb
        counts = np.asarray(self.stream.counts)
        shape = np.asarray(self.region_shape)
        mid = (cell_lo + cell_hi + 1) // 2
        return np.clip(mid - shape // 2, 0,
                       np.maximum(counts - shape, 0))

    def _interior_box(self, start, shape=None):
        """(interior_lo, interior_hi) world box of region ``start`` (or of
        regions [..., 3]): pure geometry, extending to the full-grid
        boundary wherever the region touches it."""
        spacing = np.asarray(self.stream.spacing)
        origin = np.asarray(self.stream.origin)
        counts = np.asarray(self.stream.counts)
        lo_h, hi_h = _HALO[self.interp_method]
        start = np.asarray(start, dtype=int)
        if shape is None:
            shape = self.region_shape
        last = start + np.asarray(shape) - 1
        corner = origin + (counts - 1) * spacing
        interior_lo = np.where(start > 0,
                               origin + (start + lo_h) * spacing, origin)
        interior_hi = np.where(last < counts - 1,
                               origin + (last - hi_h) * spacing, corner)
        return interior_lo, interior_hi

    def full_grid_bytes(self):
        """Device bytes of a full-grid payload (values, plus the 27
        derivatives for Hermite methods), the escalation payload of
        ``mm.streamed_md``."""
        per_pt = 28 if self.interp_method in _HERMITE else 1
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return int(np.prod(self.stream.counts)) * itemsize * per_pt

    def _full_region_cached(self):
        """The whole on-disk grid as one region on the device: the
        escalation payload for clouds no bounded region can contain. Its
        interior is the full grid box; cached apart from the region LRU."""
        if self._full_region is None:
            self._full_region = self._build_region(
                (0, 0, 0), tuple(int(c) for c in self.stream.counts))
        return self._full_region

    def _region_cached(self, start):
        """Device region LRU keyed by start (bounded by
        ``device_regions``); falls through to the file streamer."""
        key = tuple(int(s) for s in start)
        hit = self._regions.pop(key, None)
        if hit is not None:
            self.region_hits += 1
            self._regions[key] = hit
            return hit
        self.region_misses += 1
        built = self._build_region(start)
        self._regions[key] = built
        while len(self._regions) > self.device_regions:
            self._regions.pop(next(iter(self._regions)))
        return built

    def evaluate_batch(self, positions, scaling):
        """GridEval for replica clouds scattered across the full grid:
        ``positions`` [R, N, 3], ``scaling`` [N] or [R, N]; energies [R],
        forces [R, N, 3], per-atom [R, N].

        Each replica's cloud needs to fit one region (the docking-screen
        case: small poses spread over a huge grid). Replicas are grouped
        by lattice-aligned region, each distinct region is read once per
        call (device-LRU-cached across calls), and each group is
        evaluated in one batched call; a cloud larger than a region takes
        the exact chunked evaluation.
        """
        pos = _numpy(positions)
        if pos.ndim != 3:
            raise ValueError("evaluate_batch wants positions [R, N, 3]")
        n_rep, n_atoms = pos.shape[0], pos.shape[1]
        scal = np.broadcast_to(_numpy(scaling), (n_rep, n_atoms))
        dev_pos = torch.as_tensor(positions, device=self.device)

        starts, big = [], []
        for r, p in enumerate(pos):
            try:
                starts.append(self._aligned_region_for(p))
            except ValueError:
                starts.append(np.zeros(3, dtype=int))   # placeholder
                big.append(r)                            # oversized cloud
        starts = np.stack(starts)
        small = np.setdiff1d(np.arange(n_rep), big)
        full_origin, full_corner = self.full_box

        perm, outs = [], []
        if small.size:
            uniq, inverse = np.unique(starts[small], axis=0,
                                      return_inverse=True)
            for u in range(uniq.shape[0]):
                grid, _ = self._region_cached(uniq[u])
                idx = small[np.nonzero(inverse.reshape(-1) == u)[0]]
                sel = torch.as_tensor(idx, device=self.device)
                outs.append(evaluate_streamed(
                    grid, full_origin, full_corner, dev_pos[sel],
                    torch.as_tensor(scal[idx], device=self.device),
                    self.oob_k))
                perm.append(idx)
        for r in big:
            out = self._evaluate_chunked(pos[r], scal[r])
            outs.append(GridEval(*(t[None] for t in out)))
            perm.append(np.asarray([r]))
        order = torch.as_tensor(np.argsort(np.concatenate(perm)),
                                device=self.device)
        return GridEval(*(torch.cat(parts, 0)[order]
                          for parts in zip(*outs)))

    def evaluate(self, positions, scaling):
        """GridEval for atoms [N, 3] against the streamed region.

        Atoms outside the FULL grid get the standard restraint (measured
        to the full grid box); the region contains all inside atoms, so
        region-local evaluation equals full-grid evaluation for them. A
        cloud larger than the region is evaluated exactly in
        region-sized spatial chunks."""
        try:
            grid, _ = self.region_grid(positions)
        except ValueError:
            return self._evaluate_chunked(positions, scaling)
        full_origin, full_corner = self.full_box
        return evaluate_streamed(
            grid, full_origin, full_corner,
            torch.as_tensor(positions, device=self.device),
            torch.as_tensor(scaling, device=self.device), self.oob_k)

    def _evaluate_chunked(self, positions, scaling):
        """Exact evaluation of a cloud larger than one region: bucket the
        in-grid atoms on an aligned super-lattice sized so any bucket's
        cloud plus stencil halo fits one region, evaluate each bucket
        against its own region, and stitch the per-atom results
        (out-of-grid atoms ride with the first bucket)."""
        pos = _numpy(positions)
        scal = np.broadcast_to(_numpy(scaling), pos.shape[:1])
        origin, corner = self.full_box
        spacing = np.asarray(self.stream.spacing)
        counts = np.asarray(self.stream.counts)
        lo_h, hi_h = _HALO[self.interp_method]
        shape = np.asarray(self.region_shape)
        stride = np.maximum(shape - 1 - lo_h - hi_h, 1)
        inside = np.all((pos >= origin) & (pos <= corner), axis=1)
        cell = np.clip(((pos - origin) / spacing).astype(int),
                       0, counts - 1)
        bucket = cell // stride
        if np.any(inside):
            bucket[~inside] = bucket[np.argmax(inside)]
        keys, inv = np.unique(bucket, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        forces = torch.zeros((pos.shape[0], 3), dtype=self.dtype,
                             device=self.device)
        per_atom = torch.zeros((pos.shape[0],), dtype=self.dtype,
                               device=self.device)
        for b in range(keys.shape[0]):
            idx = np.nonzero(inv == b)[0]
            grid, _ = self.region_grid(pos[idx])
            out = evaluate_streamed(
                grid, origin, corner,
                torch.as_tensor(pos[idx], device=self.device),
                torch.as_tensor(scal[idx], device=self.device), self.oob_k)
            sel = torch.as_tensor(idx, device=self.device)
            forces[sel] = out.forces.to(self.dtype)
            per_atom[sel] = out.per_atom_energy.to(self.dtype)
        return GridEval(per_atom.sum(), forces, per_atom)

    def cache_stats(self):
        return self.stream.cache_stats()

    def close(self):
        self.stream.close()
