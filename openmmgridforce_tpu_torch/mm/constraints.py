"""Holonomic bond constraints (SHAKE / RATTLE) over a replica dimension.

Constraints are relaxed with damped Jacobi sweeps: every constraint
updates at once each sweep, which batches over replicas [..., N, 3] and
converges in a few tens of sweeps for hydrogen-bond stars. SHAKE moves
post-step positions along the pre-step bond directions; RATTLE removes the
relative velocity along the constrained bonds.

The stopping rule is the JAX package's, replica by replica: the first
sweep always runs, a sweep measures its error before its own update, and a
replica stops after the first sweep whose error was within tolerance (or
after ``max_iter`` sweeps). A replica that has stopped is masked out of
later sweeps, whose updates on it are exact no-ops, so the end is checked
only every ``CHECK_EVERY`` sweeps and every replica still stops at its own
sweep. Called eagerly on the card, a block is a CUDA graph, recorded once
per constraint set and shape and replayed, and the host checks after
every block (one synchronisation per block). Inside a recorded MD segment
(``mm/graphs.py``) the stop moves onto the device, as JAX's
``lax.while_loop`` has it: blocks run in a conditional WHILE node of the
graph until no replica is active. Each call adds its sweep counts to the
function's ``stats`` (``apply_shake.stats``, ``apply_rattle.stats``), on
the device.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..ops.scatter import add_rows, row_sum_plan
from . import graphs

# sweeps between two host checks of the stopping rule
CHECK_EVERY = 4


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    idx: torch.Tensor        # [C, 2] int64 atom pairs
    length: torch.Tensor     # [C] target distances (nm)
    inv_mass: torch.Tensor   # [N] 1/mass

    @property
    def num_constraints(self) -> int:
        return self.idx.shape[0]


def constraints_from_bonds(bond_idx, bond_r0, masses, which: str = "h_bonds",
                           dtype=torch.float64, device=None
                           ) -> ConstraintSet:
    """Build a ConstraintSet from bonded terms, on ``device`` (the CUDA
    card unless ``device="cpu"``).

    ``which``: "h_bonds" constrains bonds involving a hydrogen (mass < 2;
    a repartitioned hydrogen is not detectable, so pass the topology's
    original masses); "all_bonds" constrains every bond.
    """
    if which not in ("h_bonds", "all_bonds"):
        raise ValueError(which)
    device = resolve_device(device)
    masses = np.asarray(masses, dtype=np.float64)
    bond_idx = np.asarray(bond_idx, dtype=np.int64).reshape(-1, 2)
    bond_r0 = np.asarray(bond_r0, dtype=np.float64)
    if which == "all_bonds":
        mask = np.ones(len(bond_idx), dtype=bool)
    else:
        is_h = masses < 2.0
        mask = is_h[bond_idx[:, 0]] | is_h[bond_idx[:, 1]]
    return ConstraintSet(
        idx=torch.as_tensor(bond_idx[mask], device=device),
        length=torch.as_tensor(bond_r0[mask], dtype=dtype, device=device),
        inv_mass=torch.as_tensor(1.0 / masses, dtype=dtype, device=device))


class SweepStats:
    """Sweep counts of a constraint function since the last ``reset``:
    calls, the sweeps each batched call ran (``executed``) and each
    replica's own count (the JAX loop's), summed and maximised on the
    device, in buffers that recorded segments update in place, until
    ``summary`` reads them. Calls while a segment block warms up before
    its capture are not counted."""

    def __init__(self):
        self._acc = {}   # device -> (sums [4], maxes [2]) int64

    def reset(self):
        for sums, maxes in self._acc.values():
            sums.zero_()
            maxes.zero_()

    def add(self, executed, sweeps):
        acc = self._acc.get(sweeps.device)
        if acc is None:
            acc = self._acc[sweeps.device] = (
                torch.zeros(4, dtype=torch.int64, device=sweeps.device),
                torch.zeros(2, dtype=torch.int64, device=sweeps.device))
        if graphs.warming_up():
            return
        sums, maxes = acc
        total = sweeps.sum()
        if not torch.is_tensor(executed):
            executed = torch.full_like(total, executed)
        sums.add_(torch.stack([torch.ones_like(total),
                               torch.full_like(total, sweeps.numel()),
                               total, executed]))
        torch.maximum(maxes, torch.stack([sweeps.max(), executed]),
                      out=maxes)

    def summary(self) -> dict:
        calls = replicas = total = executed = peak = peak_exec = 0
        for sums, maxes in self._acc.values():
            c, r, t, e = sums.tolist()
            calls, replicas = calls + c, replicas + r
            total, executed = total + t, executed + e
            peak = max(peak, int(maxes[0]))
            peak_exec = max(peak_exec, int(maxes[1]))
        if not calls:
            return {"calls": 0}
        return {"calls": calls,
                "mean_sweeps": total / replicas,
                "max_sweeps": peak,
                "mean_executed": executed / calls,
                "max_executed": peak_exec}


class _Relaxation:
    """Masked Jacobi sweeps over buffers: ``sweep(bufs, state, active,
    omega)`` applies one update to ``state`` in place where ``active``
    and returns err [...], measured before the update; ``bufs`` holds the
    tensors it reads. ``record`` makes a CUDA graph of one block of
    CHECK_EVERY sweeps, replayed in place of the block's few dozen small
    launches."""

    def __init__(self, sweep, bufs, state, threshold, omega):
        self.sweep, self.bufs, self.state = sweep, bufs, state
        self.threshold, self.omega = threshold, omega
        batch = state.shape[:-2]
        self.active = torch.ones(batch, dtype=torch.bool,
                                 device=state.device)
        self.sweeps = torch.zeros(batch, dtype=torch.int64,
                                  device=state.device)
        self.graph = None

    def block(self, n=CHECK_EVERY):
        for _ in range(n):
            err = self.sweep(self.bufs, self.state, self.active, self.omega)
            self.sweeps.add_(self.active)
            self.active.logical_and_(err > self.threshold)

    def run_device(self, max_iter: int):
        """The sweeps with the stop on the device, for a recorded segment:
        blocks of CHECK_EVERY sweeps in a conditional WHILE node while a
        replica is active and a whole block fits in ``max_iter``, then the
        rest of ``max_iter`` masked. Every replica stops at its own sweep.
        Returns the sweeps the batch ran, a 0-d tensor."""
        self.active.fill_(True)
        self.sweeps.zero_()
        n_full = max_iter // CHECK_EVERY
        blocks = torch.zeros((), dtype=torch.int64, device=self.state.device)
        if n_full:
            def body():
                self.block()
                blocks.add_(1)
                return self.active.any() & (blocks < n_full)

            graphs.while_loop(body)
        executed = blocks * CHECK_EVERY
        rest = max_iter - n_full * CHECK_EVERY
        if rest:
            executed = executed + self.active.any() * rest
            self.block(rest)
        return executed

    def record(self):
        """Capture one block on a side stream, after running one as it is
        (which loads every kernel the block launches)."""
        self.block()
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.graph.capture_begin()
            self.block()
            self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)

    def run(self, max_iter: int) -> int:
        """Sweep from every replica active until all have stopped or
        ``max_iter`` sweeps have run; returns the sweeps the batch ran."""
        self.active.fill_(True)
        self.sweeps.zero_()
        executed = 0
        while executed < max_iter:
            n = min(CHECK_EVERY, max_iter - executed)
            if n == CHECK_EVERY and self.graph is not None:
                self.graph.replay()
            else:
                self.block(n)
            executed += n
            if not bool(self.active.any()):
                break
        return executed


# recorded relaxations on the card, by what their graph was recorded for;
# the oldest is dropped beyond _GRAPH_CACHE
_GRAPHS = collections.OrderedDict()
_GRAPH_CACHE = 8


def _relax(sweep, cs, bufs, inputs, state, max_iter, threshold, omega):
    """Sweep a copy of ``state`` [..., N, 3]; ``bufs`` are the tensors of
    the constraint set, ``inputs`` those of this call. Returns (state,
    sweeps [...], sweeps the batch ran). Inside a recorded segment the
    sweeps stop on the device (``run_device``). Otherwise, on a CUDA
    device, they run as replays of a graph recorded once per constraint
    set, shape, dtype, device, threshold and omega, over buffers this
    call's values are copied into."""
    if not state.is_cuda or graphs.recording():
        r = _Relaxation(sweep, {**bufs, **inputs}, state.clone(), threshold,
                        omega)
        executed = (r.run_device(max_iter) if state.is_cuda
                    else r.run(max_iter))
        return r.state, r.sweeps, executed
    key = (sweep, id(cs), tuple(state.shape), state.dtype, state.device,
           threshold, omega)
    r = _GRAPHS.get(key)
    if r is None:
        r = _Relaxation(sweep, {**bufs, **{k: v.clone() for k, v in
                                           inputs.items()}},
                        state.clone(), threshold, omega)
        r.cs = cs     # held, so that no other set takes its id
        with torch.cuda.device(state.device):
            r.record()
        _GRAPHS[key] = r
        while len(_GRAPHS) > _GRAPH_CACHE:
            _GRAPHS.popitem(last=False)
    for k, v in inputs.items():
        r.bufs[k].copy_(v)
    r.state.copy_(state)
    with torch.cuda.device(state.device):
        executed = r.run(max_iter)
    return r.state.clone(), r.sweeps.clone(), executed


def _pair_tensors(cs: ConstraintSet):
    """The tensors every sweep reads: both atoms of each pair in one index
    (first atoms, then second atoms), the pairs' inverse masses, and the
    row sum that applies a pair's update to its atoms weighted -1/m_i and
    +1/m_j (``ops/scatter.py``)."""
    i, j = cs.idx[:, 0], cs.idx[:, 1]
    im_i = cs.inv_mass[i][:, None]
    im_j = cs.inv_mass[j][:, None]
    zero = torch.zeros((), dtype=cs.inv_mass.dtype,
                       device=cs.inv_mass.device)
    idx = torch.cat([i, j])
    plan = row_sum_plan(idx, cs.inv_mass.shape[0], (cs.idx,),
                        coef=torch.cat([-im_i, im_j])[:, 0],
                        src_rows=cs.num_constraints)
    return {"idx": idx, "im_i": im_i, "im_j": im_j, "plan": plan,
            "zero": zero}


def _pair_diff(b, x):
    """x_i - x_j [..., C, 3] of every pair, from one gather."""
    n = b["im_i"].shape[0]
    xp = x.index_select(-2, b["idx"])
    return xp[..., :n, :] - xp[..., n:, :]


def _scatter_(b, x, update):
    """Apply ``update`` [..., C, 3] to both atoms of every pair of x, in
    place, weighted -1/m_i and +1/m_j (the JAX package's two ``.at[].add``
    in one row sum: an atom in several constraints receives every
    contribution)."""
    add_rows(x, b["plan"], update)


def _shake_sweep(b, x, active, omega):
    d = _pair_diff(b, x)
    r2 = (d * d).sum(-1, keepdim=True)
    diff = r2 - b["d0_sq"]
    denom = b["two_im"] * (d * b["d_ref"]).sum(-1, keepdim=True)
    num = diff if omega == 1.0 else omega * diff
    g = num / torch.where(denom.abs() > 1e-12, denom, b["floor"])
    _scatter_(b, x, torch.where(active[..., None, None], g * b["d_ref"],
                                b["zero"]))
    # max |diff| / d0^2 over the constraints (the infinity norm)
    return torch.linalg.vector_norm(diff / b["d0_sq"], float("inf"),
                                    dim=(-2, -1))


def _rattle_sweep(b, v, active, omega):
    vrel = (_pair_diff(b, v) * b["d"]).sum(-1, keepdim=True)
    k = (vrel if omega == 1.0 else omega * vrel) / b["den"]
    _scatter_(b, v, torch.where(active[..., None, None], k * b["d"],
                                b["zero"]))
    return torch.linalg.vector_norm(vrel, float("inf"), dim=(-2, -1))


def apply_shake(cs: ConstraintSet, x_ref, x_new, tol=1e-5, max_iter=150,
                omega=1.0):
    """Project ``x_new`` [..., N, 3] onto the constraint manifold, moving
    along the directions of ``x_ref`` (the pre-step positions).

    Returns (constrained positions, sweeps [...] per replica). A replica
    stops after the first sweep whose error max |r^2 - d^2| / d^2 was at
    most 2 tol, or after ``max_iter`` sweeps.
    """
    if cs.num_constraints == 0:
        return x_new, torch.zeros(x_new.shape[:-2], dtype=torch.int64,
                                  device=x_new.device)
    b = _pair_tensors(cs)
    b["two_im"] = 2.0 * (b["im_i"] + b["im_j"])
    b["d0_sq"] = (cs.length * cs.length)[:, None]
    b["floor"] = torch.full((), 1e-12, dtype=x_new.dtype,
                            device=x_new.device)
    inputs = {"d_ref": _pair_diff(b, x_ref)}
    x, sweeps, executed = _relax(_shake_sweep, cs, b, inputs, x_new,
                                 max_iter, 2.0 * tol, omega)
    apply_shake.stats.add(executed, sweeps)
    return x, sweeps


def apply_rattle(cs: ConstraintSet, x, v, tol=1e-8, max_iter=100,
                 omega=1.0):
    """Remove the velocity components along constrained bonds.

    Returns (velocities, sweeps [...] per replica). A replica stops after
    the first sweep whose error max |(v_i - v_j) . d| was at most ``tol``
    (absolute, nm^2/ps), or after ``max_iter`` sweeps.
    """
    if cs.num_constraints == 0:
        return v, torch.zeros(v.shape[:-2], dtype=torch.int64,
                              device=v.device)
    b = _pair_tensors(cs)
    d = _pair_diff(b, x)
    inputs = {"d": d,
              "den": (b["im_i"] + b["im_j"]) * (d * d).sum(-1, keepdim=True)}
    v, sweeps, executed = _relax(_rattle_sweep, cs, b, inputs, v, max_iter,
                                 tol, omega)
    apply_rattle.stats.add(executed, sweeps)
    return v, sweeps


apply_shake.stats = SweepStats()
apply_rattle.stats = SweepStats()
