"""Batched MD on out-of-core grids: scattered replica clouds, each stepping
against its own streamed region.

The port of the JAX package's ``mm/streamed_md.py`` (the counterpart of
running the reference's tiled MD loop, CudaGridForceKernels.cpp:787-1028,
over many independent replicas). A host-orchestrated segment loop groups
replicas by region (each set's per-replica region starts, with
hysteresis, union-first sharing and region-pool joining), runs each
group's segment as replays of a CUDA graph of its steps against the
group's region payload (a fused packed table, or raw region grids when no
pack fits the budget), and reforms the groups between segments as the
clouds drift. Atoms outside a set's full grid take that set's full-box restraint.
Every step of a segment folds the in-grid cloud's bounding box into a
running one; the host downloads only the [R, S, 12] final and running
boxes per segment, never the positions. A replica whose running box left
its region's interior re-runs the segment from its saved start in
quarter-length chunks with its region re-centred (depth 2), and then moves
onto the whole grid ("full-grid escalation", demoted after 4 calm rounds
with 16 spare cells), which keeps the reference's every-step exactness for
any trajectory. A segment's noise is drawn once per replica, [k, R, N, 3],
before the replicas are grouped: every group takes its replicas' rows and
every retry or escalation re-run its steps' slice of them, so a retry
replays the first attempt's trajectory on a better region and no
replica's trajectory depends on how the batch was grouped (the JAX
engine's per-replica keys do the same).

The engine generalises over several :class:`StreamSet`\\ s (co-located
grids acting on one atom subset each, with one restraint per set), a
pluggable integrator ``step_factory`` and a pluggable ``base_force`` for
everything that is not a streamed grid.

Escalated replicas run on the card against the raw full grids
(``StreamedGridEvaluator._full_region_cached``), and
``full_region_budget_bytes`` budgets that device memory.
"""

from __future__ import annotations

import collections
import functools
from typing import Sequence

import numpy as np
import torch

from ..grid import InterpolationMethod
from ..io.streaming import _HALO, StreamedGridEvaluator
from ..ops.interpolate import evaluate_grid
from ..ops.packed import (combine_packed_grids, evaluate_multi, pack_grid,
                          pack_grids_fused)
from . import graphs
from .integrators import MDState, _recorded, make_langevin_step
from .system import System, energy_and_forces

# recorded group segments an engine keeps (by payloads and group size)
_GROUP_GRAPHS = 8


def _group_size(b: int, n_rep: int) -> int:
    """The batch a group of ``b`` of ``n_rep`` replicas is recorded at: the
    next power of two, at most ``n_rep``, so that a payload needs a few
    recordings, not one per group size."""
    return min(1 << (b - 1).bit_length(), n_rep)


def _pad_rows(t, size, dim=0):
    """``t`` with copies of its first row along ``dim`` up to ``size``."""
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    first = t.narrow(dim, 0, 1)
    return torch.cat([t, first.expand(*(extra if d == dim else -1
                                        for d in range(t.dim())))], dim=dim)


def _cloud_bounds(positions, full_lo, full_hi):
    """Bbox of the in-grid atoms of [..., N, 3] positions: ([..., 3],
    [..., 3]). An all-outside cloud yields +-inf bounds, so ``any_in``
    follows from finiteness."""
    inside = ((positions >= full_lo) & (positions <= full_hi)).all(
        -1, keepdim=True)
    inf = torch.full((), float("inf"), dtype=positions.dtype,
                     device=positions.device)
    lo = torch.where(inside, positions, inf).amin(-2)
    hi = torch.where(inside, positions, -inf).amax(-2)
    return lo, hi


def _unpack_set_bounds(b12):
    """Host-side split of one set's [R, 12] per-segment download into
    ((fin_lo, fin_hi, fin_in), (run_lo, run_hi, run_in))."""
    b = np.asarray(b12)
    fin_lo, fin_hi = b[:, 0:3], b[:, 3:6]
    run_lo, run_hi = b[:, 6:9], b[:, 9:12]
    return ((fin_lo, fin_hi, np.isfinite(fin_lo).all(axis=1)),
            (run_lo, run_hi, np.isfinite(run_lo).all(axis=1)))


class _RegionCrossing(RuntimeError):
    """A replica's cloud left its region's interior within a segment."""

    def __init__(self, message, bad):
        super().__init__(message)
        self.bad = np.asarray(bad, dtype=int)


class StreamSet:
    """One co-located group of streamed grids acting on one atom subset.

    Owns the per-set region state: assignment with hysteresis and forced
    re-centring, the fused packed-region LRU, interior geometry and
    running-bbox containment checks, vectorised over replicas.

    ``atom_indices``: indices into the full position array this set's
    grids act on (None = all atoms). ``oob_k``: the full-box restraint
    stiffness (default: the first evaluator's, one restraint per fused
    set). ``pack_budget_bytes`` bounds the total resident pack bytes: a
    new pack first evicts least-recently-used packs not pinned by the
    current segment round, and a pack that still does not fit falls back
    to the direct stencil on the raw region grids.
    ``full_region_budget_bytes`` bounds the device bytes of the full-grid
    escalation payload; with less room, a cloud no region can hold
    raises.
    """

    _FULL = np.array([-1, -1, -1])   # sentinel region start: whole grid

    def __init__(self, evaluators: Sequence[StreamedGridEvaluator],
                 scalings, atom_indices=None, oob_k=None,
                 pack_budget_bytes: int = 512 << 20,
                 full_region_budget_bytes: int = 4 << 30):
        if not evaluators:
            raise ValueError("need at least one evaluator")
        ev0 = evaluators[0]
        for ev in evaluators[1:]:
            if (tuple(ev.stream.counts) != tuple(ev0.stream.counts)
                    or not np.allclose(ev.stream.spacing,
                                       ev0.stream.spacing)
                    or not np.allclose(ev.stream.origin,
                                       ev0.stream.origin)
                    or tuple(ev.region_shape) != tuple(ev0.region_shape)):
                raise ValueError(
                    "evaluators must be co-located (same counts, "
                    "spacing, origin) with identical region shapes")
        if len(scalings) != len(evaluators):
            raise ValueError(
                f"{len(scalings)} scalings for {len(evaluators)} "
                "evaluators")
        self.evaluators = list(evaluators)
        self.device = ev0.device
        self.scal_stack = np.stack([np.asarray(s) for s in scalings])
        self.atom_idx = (None if atom_indices is None
                         else np.asarray(atom_indices, dtype=int))
        self.oob_k = float(ev0.oob_k if oob_k is None else oob_k)
        self.pack_budget = int(pack_budget_bytes)
        self._starts = None     # [R, 3] per-replica region hysteresis
        self._recenter = None   # [R] bool: force re-center on next assign
        self._union_start = None  # sticky shared-region start (union mode)
        self._packed = {}       # key -> (payload, interior)
        self._packed_bytes = {}  # key -> resident device bytes
        self._round_keys = set()  # keys pinned by the current round
        self.full_region_budget = int(full_region_budget_bytes)
        self._full = None        # [R] bool: replica is on the full grid
        self._calm = None        # [R] consecutive region-fitting rounds
        self._full_pay = None
        self.full_escalations = 0
        self.packs_built = 0
        self.direct_builds = 0
        self._tensors = {}      # static device tensors, by what they hold

    # --- geometry -------------------------------------------------------
    @property
    def full_box(self):
        return self.evaluators[0].full_box

    def take(self, positions):
        """This set's atoms from full positions ([..., N, 3])."""
        if self.atom_idx is None:
            return positions
        return positions[..., torch.as_tensor(self.atom_idx,
                                              device=positions.device), :]

    def gather_index(self, n_total):
        """The set's atom indices as a device tensor (made once), or None
        when the set covers all atoms in order."""
        idx = self.atom_idx
        if idx is None or (len(idx) == n_total
                           and np.array_equal(idx, np.arange(n_total))):
            return None
        key = ("gather", n_total)
        if key not in self._tensors:
            self._tensors[key] = torch.as_tensor(idx, device=self.device)
        return self._tensors[key]

    def device_tensors(self, dtype, device):
        """(scalings [G, n], full box (lo [3], hi [3])) on ``device``, made
        once: a recorded segment reads them at fixed addresses."""
        key = ("set", dtype, device)
        if key not in self._tensors:
            box = tuple(torch.as_tensor(np.asarray(b, np.float64),
                                        dtype=dtype, device=device)
                        for b in self.full_box)
            self._tensors[key] = (torch.as_tensor(self.scal_stack,
                                                  dtype=dtype,
                                                  device=device), box)
        return self._tensors[key]

    def resident_payloads(self):
        """Identities of what this set's payloads are made of that is held
        on the device: its fused packs and its evaluators' region grids
        (region LRU and full grid)."""
        live = {id(v[0]) for v in self._packed.values()}
        for ev in self.evaluators:
            live |= {id(v[0]) for v in ev._regions.values()}
            if ev._full_region is not None:
                live.add(id(ev._full_region[0]))
        return live

    def _interior(self, start):
        """Tightest interior across evaluators' halos for one region (or
        regions [R, 3])."""
        ilo = ihi = None
        for ev in self.evaluators:
            lo_e, hi_e = ev._interior_box(start)
            ilo = lo_e if ilo is None else np.maximum(ilo, lo_e)
            ihi = hi_e if ihi is None else np.minimum(ihi, hi_e)
        return ilo, ihi

    # --- region payloads ------------------------------------------------
    def begin_round(self):
        """Start a segment round: forget which packs are pinned."""
        self._round_keys = set()

    def _evict_until(self, room_for: int):
        """Drop least-recently-used packs not pinned by the current round
        until ``room_for`` more bytes fit the budget. Returns True when
        they do."""
        def resident():
            return sum(self._packed_bytes.values())
        for key in list(self._packed):
            if resident() + room_for <= self.pack_budget:
                break
            if key in self._round_keys:
                continue
            self._packed.pop(key)
            self._packed_bytes.pop(key)
        return resident() + room_for <= self.pack_budget

    def can_escalate(self):
        return (sum(ev.full_grid_bytes() for ev in self.evaluators)
                <= self.full_region_budget)

    def escalate(self, bad, n_rep):
        """Move replicas ``bad`` onto the full-grid payload."""
        if self._full is None or len(self._full) != n_rep:
            self._full = np.zeros(n_rep, dtype=bool)
        bad = np.asarray(bad, dtype=int)
        self._full[bad] = True
        # restart the demotion clock, or a runaway whose endpoint bbox
        # fits a region (while its running bbox does not) is demoted on
        # the next assign and re-escalates forever
        if self._calm is not None and len(self._calm) == n_rep:
            self._calm[bad] = 0
        self.full_escalations += len(bad)

    def _full_payload(self):
        if self._full_pay is None:
            grids = [ev._full_region_cached()[0] for ev in self.evaluators]
            lo, hi = self.full_box
            self._full_pay = (tuple(grids),
                              (np.asarray(lo), np.asarray(hi)))
        return self._full_pay

    def payload(self, start):
        """Device payload for region ``start``: each evaluator's region
        (through its device LRU) packed to per-cell coefficients and fused
        into one multi-grid row table, or, when the pack does not fit the
        budget, the tuple of raw region Grids for the direct stencil. The
        sentinel start (-1, -1, -1) gives the full-grid payload. Returns
        ``(payload, (interior_lo, interior_hi))``, LRU-cached."""
        key = tuple(int(s) for s in start)
        if key == (-1, -1, -1):
            return self._full_payload()
        self._round_keys.add(key)
        hit = self._packed.pop(key, None)
        if hit is not None:
            self._packed[key] = hit
            return hit
        grids, ilo, ihi = [], None, None
        for ev in self.evaluators:
            g, (lo, hi) = ev._region_cached(start)
            grids.append(g)
            ilo = lo if ilo is None else np.maximum(ilo, lo)
            ihi = hi if ihi is None else np.minimum(ihi, hi)
        # mixed interpolation methods or per-grid oob_k cannot fuse into
        # one row table: evaluate them with the direct stencil
        if any(int(g.interp_method) != int(grids[0].interp_method)
               or float(g.oob_k) != float(grids[0].oob_k)
               for g in grids[1:]):
            self.direct_builds += 1
            return (tuple(grids), (ilo, ihi))
        method = int(grids[0].interp_method)
        ncells = int(np.prod(np.asarray(grids[0].counts) - 1))
        kcoef = {0: 8, 1: 64, 2: 64, 3: 216}[method]
        nbytes = (ncells * len(grids) * kcoef
                  * grids[0].vals.element_size())
        if self._evict_until(nbytes):
            if method in (int(InterpolationMethod.TRILINEAR),
                          int(InterpolationMethod.BSPLINE)):
                built = (pack_grids_fused(grids, device=self.device),
                         (ilo, ihi))
            else:
                built = (combine_packed_grids(
                    [pack_grid(g) for g in grids]), (ilo, ihi))
            self._packed[key] = built
            self._packed_bytes[key] = nbytes
            self.packs_built += 1
        else:
            self.direct_builds += 1
            # raw grids live in the evaluators' own device LRUs
            built = (tuple(grids), (ilo, ihi))
        return built

    # --- assignment -----------------------------------------------------
    def assign(self, bounds):
        """Per-replica region starts from in-grid cloud bboxes, with
        hysteresis: a replica keeps its region while its cloud stays
        inside that region's interior; otherwise (or when a crossing retry
        flagged it for re-centring) a region is centred on the cloud.
        All-outside replicas keep whatever region they have."""
        blo, bhi, any_in = bounds
        ev0 = self.evaluators[0]
        spacing = np.asarray(ev0.stream.spacing)
        origin = np.asarray(ev0.stream.origin)
        counts = np.asarray(ev0.stream.counts)
        shape = np.asarray(ev0.region_shape)
        # widest stencil halo across evaluators
        lo_h = max(_HALO[ev.interp_method][0] for ev in self.evaluators)
        hi_h = max(_HALO[ev.interp_method][1] for ev in self.evaluators)
        n_rep = len(any_in)
        if self._starts is not None and len(self._starts) != n_rep:
            self._starts = None

        # placeholder bbox for all-outside replicas (start stays 0/prev)
        safe_lo = np.where(any_in[:, None], blo, origin)
        safe_hi = np.where(any_in[:, None], bhi, origin)
        cell_lo = np.clip(
            np.floor((safe_lo - origin) / spacing).astype(int) - lo_h,
            0, counts - 1)
        cell_hi = np.clip(
            np.floor((safe_hi - origin) / spacing).astype(int) + 1 + hi_h,
            0, counts - 1)
        need = cell_hi - cell_lo + 1
        if self._full is None or len(self._full) != n_rep:
            self._full = np.zeros(n_rep, dtype=bool)
        too_big = any_in & np.any(need > shape, axis=1) & ~self._full
        if np.any(too_big):
            if self.can_escalate():
                self.escalate(np.nonzero(too_big)[0], n_rep)
            else:
                i = int(np.argmax(too_big))
                raise ValueError(
                    f"replica {i}'s cloud needs region {tuple(need[i])}"
                    f" > configured {tuple(shape)}; enlarge region_shape")
        # demote full-grid replicas whose cloud has fit a region with 8
        # spare cells a side for 4 consecutive assignments
        fits = any_in & np.all(need <= shape - 16, axis=1)
        if self._calm is None or len(self._calm) != n_rep:
            self._calm = np.zeros(n_rep, dtype=int)
        self._calm = np.where(fits, self._calm + 1, 0)
        demote = self._full & fits & (self._calm >= 4)
        self._full &= ~demote
        mid = (cell_lo + cell_hi + 1) // 2
        max_start = np.maximum(counts - shape, 0)
        centered = np.clip(mid - shape // 2, 0, max_start)
        # union-first sharing: when the union of all active clouds fits
        # one region, every active replica gets the same, sticky start
        # (one group, one resident pack); crossing-retry violators are
        # excluded
        recenter = (self._recenter
                    if self._recenter is not None
                    and len(self._recenter) == n_rep
                    else np.zeros(n_rep, dtype=bool))
        active = any_in & ~self._full & ~recenter
        union_start = None
        if np.any(active):
            u_lo = cell_lo[active].min(axis=0)
            u_hi = cell_hi[active].max(axis=0)
            if np.all(u_hi - u_lo + 1 <= shape):
                prev = self._union_start
                if (prev is not None and np.all(u_lo >= prev)
                        and np.all(u_hi <= prev + shape - 1)):
                    union_start = prev
                else:
                    umid = (u_lo + u_hi + 1) // 2
                    stride = np.maximum(shape // 16, 1)
                    union_start = np.clip(
                        (umid - shape // 2 + stride // 2)
                        // stride * stride, 0, max_start)
                    if not (np.all(u_lo >= union_start) and np.all(
                            u_hi <= union_start + shape - 1)):
                        # the lattice snap uncovered the union
                        union_start = np.clip(umid - shape // 2, 0,
                                              max_start)
        self._union_start = union_start

        if self._starts is None:
            keep = np.zeros(n_rep, dtype=bool)
            starts = np.where(any_in[:, None], centered, 0)
        else:
            ilo, ihi = self._interior(self._starts)
            keep = (~any_in) | (np.all(blo >= ilo, axis=1)
                                & np.all(bhi <= ihi, axis=1))
            if (self._recenter is not None
                    and len(self._recenter) == n_rep):
                keep &= ~(self._recenter & any_in)
            # a just-demoted replica's stored start is the -1 sentinel
            keep &= ~demote
            starts = np.where(keep[:, None], self._starts, centered)
        if union_start is not None:
            starts = np.where(active[:, None], union_start, starts)
        elif np.any(active):
            # region-pool joining: the union no longer fits one region,
            # so each re-assigned cloud joins an existing region (a kept
            # replica's start or one founded this round) with slack, and
            # founds a lattice-snapped region only when none fits
            slack = np.maximum(shape // 32, 2)
            stride = np.maximum(shape // 16, 1)
            pool = [st for st in np.unique(
                starts[active & keep], axis=0)] if np.any(
                    active & keep) else []
            for i in np.nonzero(active & ~keep)[0]:
                placed = False
                for st in pool:
                    if (np.all(cell_lo[i] >= st + slack)
                            and np.all(cell_hi[i]
                                       <= st + shape - 1 - slack)):
                        starts[i] = st
                        placed = True
                        break
                if not placed:
                    st = np.clip(
                        (mid[i] - shape // 2 + stride // 2)
                        // stride * stride, 0, max_start)
                    if not (np.all(cell_lo[i] >= st)
                            and np.all(cell_hi[i]
                                       <= st + shape - 1)):
                        st = np.clip(mid[i] - shape // 2, 0, max_start)
                    starts[i] = st
                    pool.append(st)
        # crossing-retry violators get regions centred on their clouds,
        # pooled among themselves with a wider slack (a mass crossing
        # must not fragment into per-replica starts)
        rec = recenter & any_in & ~self._full
        if np.count_nonzero(rec) > 1:
            slack2 = np.maximum(shape // 8, 2)
            pool2 = []
            for i in np.nonzero(rec)[0]:
                placed = False
                for st in pool2:
                    if (np.all(cell_lo[i] >= st + slack2)
                            and np.all(cell_hi[i]
                                       <= st + shape - 1 - slack2)):
                        starts[i] = st
                        placed = True
                        break
                if not placed:
                    starts[i] = centered[i]     # founder: exact center
                    pool2.append(centered[i])
        starts = np.where(self._full[:, None], self._FULL, starts)
        self._recenter = None
        self._starts = starts
        return starts

    def check(self, run_bounds, interior, idx):
        """Replica indices (from ``idx``) whose running in-grid cloud bbox
        (min/max over every step of the segment) left ``interior``;
        replicas outside the full grid the whole segment are exempt."""
        blo, bhi, any_in = run_bounds
        ilo, ihi = interior
        ok = ((~any_in[idx])
              | (np.all(blo[idx] >= ilo, axis=1)
                 & np.all(bhi[idx] <= ihi, axis=1)))
        return np.asarray(idx)[~ok]


def _default_step_factory(dt, friction, scheme):
    def factory(force_fn, t, base_args):
        return make_langevin_step(force_fn, base_args.masses, dt,
                                  friction, t, scheme=scheme,
                                  constraints=base_args.constraints)
    return factory


def _payload_ids(payload):
    """A payload's identity: a fused pack's, or its region Grids' for the
    direct stencil."""
    if isinstance(payload, tuple):
        return tuple(id(g) for g in payload)
    return (id(payload),)


class _GroupSegment:
    """One group's steps over static buffers: the carry (positions,
    velocities, and each set's last and running in-grid bbox), the group's
    temperatures [B, 1, 1], and the payloads and base arguments it reads
    (held, so that no other object takes their identities). Its closures
    do not refer to it: a dropped group segment frees its recordings and
    payloads at once, not at the next garbage collection."""

    def __init__(self, md, states, carry, base_args, payloads, scals, boxes,
                 gathers, noisy):
        x = states.positions
        payloads = self.payloads = list(payloads)
        self.base_args = base_args
        self.temperature = torch.zeros((x.shape[0], 1, 1), dtype=x.dtype,
                                       device=x.device)
        ks = [s.oob_k for s in md.sets]
        base_force = md.base_force

        def force_fn(pos):
            f = base_force(base_args, pos)
            for pay, sc, box, k, g in zip(payloads, scals, boxes, ks,
                                          gathers):
                f = f + _set_forces(pos, pay, sc, box, k, g)
            return f

        step = md.step_factory(force_fn, self.temperature, base_args)
        gen = states.generator

        def advance(carry, noise):
            state = MDState(carry[0], carry[1], gen)
            state = step(state, noise) if noisy else step(state)
            out = [state.positions, state.velocities]
            for si, (g, box) in enumerate(zip(gathers, boxes)):
                lo, hi = _cloud_bounds(_sub(state.positions, g), *box)
                rlo, rhi = carry[2 + 4 * si + 2:2 + 4 * si + 4]
                out += [lo, hi, torch.minimum(rlo, lo),
                        torch.maximum(rhi, hi)]
            return tuple(out)

        self.segment = graphs.Segment(
            advance, carry, noise_shape=x.shape if noisy else None,
            generators=(() if noisy or gen is None else (gen,)))


def _sub(pos, gather):
    return pos if gather is None else pos.index_select(-2, gather)


def _default_base_force(base_args, x):
    return energy_and_forces(base_args, [], x)[1]


def _set_forces(x, payload, scaling, box, oob_k, gather, energy=False):
    """One set's forces on its atoms of ``x`` [B, N, 3]: the region
    payload inside the set's full grid, the full-box restraint outside.
    With ``energy``, ``(energy per leading index, forces)``: what the
    compat API's streamed minimiser descends (``api/context.py``); the
    recorded MD steps ask for the forces alone."""
    xi = _sub(x, gather)
    if isinstance(payload, tuple):            # direct stencil
        res = [evaluate_grid(gr, xi, scaling[gi])
               for gi, gr in enumerate(payload)]
    else:
        res = [evaluate_multi(payload, xi, scaling)]
    blo, bhi = box
    inside = ((xi >= blo) & (xi <= bhi)).all(-1, keepdim=True)
    zero = torch.zeros((), dtype=xi.dtype, device=xi.device)
    dev = torch.where(xi < blo, xi - blo,
                      torch.where(xi > bhi, xi - bhi, zero))
    fr = functools.reduce(torch.add, (r.forces for r in res))
    fi = torch.where(inside, fr.to(xi.dtype), -oob_k * dev)
    if gather is not None:
        fi = torch.zeros_like(x).index_add_(-2, gather, fi)
    if not energy:
        return fi
    pa = functools.reduce(torch.add, (r.per_atom_energy for r in res))
    e = torch.where(inside[..., 0], pa.to(xi.dtype),
                    0.5 * oob_k * (dev * dev).sum(-1)).sum(-1)
    return e, fi


class StreamedBatchMD:
    """Langevin MD for a batch of replica clouds over file-backed grids.

    Default construction: ``evaluators`` are co-located
    :class:`StreamedGridEvaluator`\\ s (one per grid file, e.g.
    charge/ljr/lja over the same box), ``scalings`` one per-atom scaling
    array per evaluator, and ``system`` supplies masses, bonded terms and
    constraints. Each replica's cloud must fit one region at a time; the
    batch may scatter anywhere.

    Generalised construction: pass ``sets`` (a list of
    :class:`StreamSet`), a ``step_factory`` ``(force_fn, temperature,
    base_args) -> step_fn`` and a ``base_force`` ``(base_args, x) ->
    forces`` for every non-streamed term; ``run(..., base_args=...)``
    hands whatever they need to them. ``temperature`` is a [B, 1, 1]
    tensor that the step must read at every step (a recorded segment
    copies each group's temperatures into it). A step that takes a
    ``noise`` argument gets the segment's per-replica noise rows [B, N, 3]
    for each step, replayed exactly by crossing retries; a step that takes
    none is called as ``step(state)`` and draws what it needs itself, as
    before (a retry then draws afresh).

    On the card each group's segment replays CUDA graphs of its steps
    (``mm/graphs.py``), recorded once per payload and group size (groups
    padded to the next power of two) and kept while the payloads stay
    resident; only the [R, S, 12] bounds of a segment are downloaded.
    """

    def __init__(self, evaluators=None, scalings=None, system: System = None,
                 dt: float = 0.001, friction: float = 1.0,
                 scheme: str = "classic", refresh_steps: int = 50, *,
                 sets: Sequence[StreamSet] = None, step_factory=None,
                 base_force=None):
        if sets is None:
            sets = [StreamSet(evaluators, scalings)]
        elif evaluators is not None or scalings is not None:
            raise ValueError("pass either evaluators/scalings or sets")
        if not sets:
            raise ValueError("need at least one StreamSet")
        if int(refresh_steps) < 1:
            raise ValueError("refresh_steps must be >= 1")
        self.sets = list(sets)
        self.system = system
        self.dt = float(dt)
        self.friction = float(friction)
        self.scheme = scheme
        self.refresh_steps = int(refresh_steps)
        self.step_factory = (step_factory if step_factory is not None
                             else _default_step_factory(self.dt,
                                                        self.friction,
                                                        scheme))
        self.base_force = (base_force if base_force is not None
                           else _default_base_force)
        self.segments = 0
        self.crossing_retries = 0
        self._graphs = collections.OrderedDict()
        self._takes_noise = None

    @property
    def evaluators(self):
        return self.sets[0].evaluators

    def _step_takes_noise(self, base_args, dtype, device):
        if self._takes_noise is None:
            t = torch.zeros((1, 1, 1), dtype=dtype, device=device)
            self._takes_noise = graphs.takes_noise(self.step_factory(
                torch.zeros_like, t, base_args))
        return self._takes_noise

    def _prune_graphs(self):
        """Drop recorded group segments whose payloads left the device
        caches: fused packs the pack LRU dropped, raw region grids the
        evaluators' region LRUs dropped. A recording holds its payloads, so
        the device memory of those it keeps stays within the caches'
        budgets."""
        live = set()
        for s in self.sets:
            live |= s.resident_payloads()
        for key, grp in list(self._graphs.items()):
            if any(not live.issuperset(_payload_ids(p))
                   for p in grp.payloads):
                del self._graphs[key]

    def _run_group(self, states, base_args, payloads, temps, n_steps,
                   noise, n_rep=None):
        """One group's segment: ``n_steps`` steps of the replicas
        ``states`` ([B, N, 3]) on their payloads, carrying each set's
        running in-grid bbox; ``noise`` [n_steps, B, N, 3] or None.
        Returns (states, bounds [B, S, 12]). On the card the steps are
        graph replays, recorded once per payload and group size, the group
        padded with copies of its first replica (and of its noise) to the
        next power of two up to ``n_rep`` (``_group_size``); the copies'
        steps are dropped."""
        b = states.positions.shape[0]
        if _recorded(states):
            size = _group_size(b, b if n_rep is None else n_rep)
            if size > b:
                states = MDState(_pad_rows(states.positions, size),
                                 _pad_rows(states.velocities, size),
                                 states.generator)
                temps = np.concatenate([temps, np.repeat(temps[:1],
                                                         size - b)])
                noise = None if noise is None else _pad_rows(noise, size, 1)
        x = states.positions
        dtype, device = x.dtype, x.device
        scals, boxes = zip(*(s.device_tensors(dtype, device)
                             for s in self.sets))
        gathers = [s.gather_index(x.shape[-2]) for s in self.sets]
        noisy = noise is not None
        carry = [x, states.velocities]
        for g, box in zip(gathers, boxes):
            lo, hi = _cloud_bounds(_sub(x, g), *box)
            carry += [lo, hi, lo, hi]
        args = (self, states, carry, base_args, payloads, scals, boxes,
                gathers, noisy)
        if _recorded(states):
            key = (tuple(_payload_ids(p) for p in payloads),
                   tuple(x.shape), dtype, device, id(base_args), noisy)
            grp = self._graphs.pop(key, None) or _GroupSegment(*args)
            self._graphs[key] = grp
            while len(self._graphs) > _GROUP_GRAPHS:
                self._graphs.popitem(last=False)
        else:
            grp = _GroupSegment(*args)
        grp.temperature.copy_(torch.as_tensor(
            np.array(temps, np.float64), dtype=dtype,
            device=device)[:, None, None])
        out = grp.segment.run(carry, n_steps, noise=noise,
                              generator=states.generator)
        per_set = [torch.cat(out[2 + 4 * si:6 + 4 * si], dim=-1)[:b]
                   for si in range(len(self.sets))]
        return (MDState(out[0][:b], out[1][:b], states.generator),
                torch.stack(per_set, dim=1))

    def run(self, states: MDState, temperatures, n_steps: int,
            base_args=None, progress=None) -> MDState:
        """Advance every replica ``n_steps``; returns the new batch.

        Host traffic per segment is O(R) floats (in-grid cloud bboxes
        computed on the device), never the position tensor. A replica
        whose cloud outruns its region mid-segment is detected at the
        segment boundary and the segment re-runs from its saved start in
        quarter-length chunks with the violators' regions re-centred;
        past that ladder the violators move onto the full grid."""
        if base_args is None:
            base_args = self.system
        x = states.positions
        n_rep = x.shape[0]
        temps = np.broadcast_to(np.asarray(temperatures, np.float64),
                                (n_rep,))
        bounds = []
        for s in self.sets:
            box = s.device_tensors(x.dtype, x.device)[1]
            lo, hi = (b.cpu().numpy() for b in _cloud_bounds(s.take(x),
                                                             *box))
            bounds.append((lo, hi, np.isfinite(lo).all(axis=1)))
        noisy = self._step_takes_noise(base_args, x.dtype, x.device)
        done = 0
        while done < n_steps:
            k = min(self.refresh_steps, n_steps - done)
            noise = (torch.randn((k,) + tuple(x.shape),
                                 generator=states.generator, dtype=x.dtype,
                                 device=x.device) if noisy else None)
            states, bounds = self._run_chunk(states, bounds, temps,
                                             base_args, k, 0, noise)
            done += k
            if progress is not None:
                progress(done, n_steps)
        return states

    def _run_chunk(self, states, bounds, temps, base_args, k, depth, noise):
        """``k`` steps from ``states``, with the retry ladder below them;
        ``noise`` [k, R, N, 3] (or None) holds the chunk's rows, which
        every re-run takes again."""
        bad = None
        try:
            return self._segment(states, bounds, temps, base_args, k, noise)
        except _RegionCrossing as rc:
            if ((depth >= 2 or k < 4)
                    and not all(s.can_escalate() for s in self.sets)):
                raise
            bad = rc.bad
        self.crossing_retries += 1
        n_rep = states.positions.shape[0]
        if depth >= 2 or k < 4:
            # the retry ladder is exhausted: the violators move onto the
            # full-grid payload, where they cannot violate again
            for s in self.sets:
                s.escalate(bad, n_rep)
            return self._run_chunk(states, bounds, temps, base_args, k,
                                   depth, noise)
        # drop the violators' hysteresis so the retry re-centres their
        # regions on the current clouds
        recenter = np.zeros(n_rep, dtype=bool)
        recenter[bad] = True
        for s in self.sets:
            if s._starts is not None:
                s._recenter = recenter
        sub = max(k // 4, 1)
        done = 0
        while done < k:
            piece = min(sub, k - done)
            states, bounds = self._run_chunk(
                states, bounds, temps, base_args, piece, depth + 1,
                None if noise is None else noise[done:done + piece])
            done += piece
        return states, bounds

    def _segment(self, states, bounds, temps, base_args, k, noise):
        n_rep = states.positions.shape[0]
        starts = [s.assign(bounds[si]) for si, s in enumerate(self.sets)]
        combo = np.hstack(starts)                         # [R, 3S]
        uniq, inverse = np.unique(combo, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        # a new round may pack fresh regions: unpin last round's packs
        for s in self.sets:
            s.begin_round()

        def group_payloads(u):
            payloads, interiors = [], []
            for si, s in enumerate(self.sets):
                pay, interior = s.payload(uniq[u][3 * si:3 * si + 3])
                payloads.append(pay)
                interiors.append(interior)
            return payloads, interiors

        if uniq.shape[0] == 1:
            payloads, interiors = group_payloads(0)
            states, b = self._run_group(states, base_args, payloads, temps,
                                        k, noise)
            bset = b.cpu().numpy()                 # one [R, S, 12] download
            perm = [np.arange(n_rep)]
            group_interiors = [interiors]
        else:
            # largest groups first: they claim the pack budget, so any
            # direct-stencil fallback lands on the fewest replicas
            group_idx = [np.nonzero(inverse == u)[0]
                         for u in range(uniq.shape[0])]
            order_u = sorted(range(uniq.shape[0]),
                             key=lambda u: -len(group_idx[u]))
            x, v, gen = states
            new_x, new_v = torch.empty_like(x), torch.empty_like(v)
            bset = np.empty((n_rep, len(self.sets), 12))
            perm, group_interiors = [], []
            for u in order_u:
                idx = group_idx[u]
                sel = torch.as_tensor(idx, device=x.device)
                payloads, interiors = group_payloads(u)
                out, b = self._run_group(
                    MDState(x[sel], v[sel], gen), base_args, payloads,
                    temps[idx], k,
                    None if noise is None else noise[:, sel], n_rep)
                new_x[sel], new_v[sel] = out.positions, out.velocities
                bset[idx] = b.cpu().numpy()
                perm.append(idx)
                group_interiors.append(interiors)
            states = MDState(new_x, new_v, gen)
        self.segments += 1
        self._prune_graphs()
        # the check sees the running bbox; the next assignment the final
        bad_all, fins = [], []
        for si, s in enumerate(self.sets):
            fin, run_b = _unpack_set_bounds(bset[:, si, :])
            fins.append(fin)
            for gi, idx in enumerate(perm):
                bad = s.check(run_b, group_interiors[gi][si], idx)
                if bad.size and s._full is not None:
                    # replicas on the full-grid payload are exempt: their
                    # segment ran on the exact full field, and a re-flag
                    # (a running bbox grazing the full box's corner) would
                    # recurse at constant depth forever
                    bad = bad[~s._full[bad]]
                if bad.size:
                    bad_all.append(bad)
        if bad_all:
            bad = np.unique(np.concatenate(bad_all))
            raise _RegionCrossing(
                f"replicas {bad.tolist()} crossed their streamed "
                f"region boundary during a {k}-step segment; lower "
                "refresh_steps or enlarge region_shape", bad)
        return states, fins
