"""Holonomic bond constraints (SHAKE / RATTLE) over a replica dimension.

Constraints are relaxed with damped Jacobi sweeps: every constraint
updates at once each sweep, which batches over replicas [..., N, 3] and
converges in a few tens of sweeps for hydrogen-bond stars. SHAKE moves
post-step positions along the pre-step bond directions; RATTLE removes the
relative velocity along the constrained bonds.

The stopping rule is the JAX package's, replica by replica: the first
sweep always runs, a sweep measures its error before its own update, and a
replica stops after the first sweep whose error was within tolerance (or
after ``max_iter`` sweeps). On the card a call is one launch of a
hand-written kernel (``ops/cuda_constraints.py``, ``csrc/constraints.cu``):
a block a replica runs the replica's sweeps to its own stop, as JAX's
``lax.while_loop`` does, inside and outside recorded segments alike, with
no host check. On the host the plain twin (``shake_plain``,
``rattle_plain``) sweeps the batch with stopped replicas masked out, whose
updates on them are exact no-ops, and checks after every sweep; the
kernel repeats its arithmetic in the same order. Each call adds its sweep
counts to the function's ``stats`` (``apply_shake.stats``,
``apply_rattle.stats``), on the device. Each call is a span,
``omgf.constraint.shake`` or ``omgf.constraint.rattle``
(``utils/observe.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda_constraints import constraint_rattle, constraint_shake
from ..ops.scatter import add_rows, row_sum_plan
from ..utils.observe import trace
from . import graphs


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
    calls, the sweeps each batched call ran (``executed``: its slowest
    replica's own count) and each replica's own count (the JAX loop's),
    summed and maximised on the device, in buffers that the card's kernel
    (``ops/cuda_constraints.py``) and recorded segments update in place,
    until ``summary`` reads them. Calls while a segment block warms up
    before its capture are not counted."""

    def __init__(self):
        self._acc = {}   # device -> (sums [4], maxes [2]) int64, scratch

    def counted(self, device):
        """The buffers a call on ``device`` counts into, made at its first
        call there, or None while a segment block warms up: (sums, maxes,
        scratch), int64 [4] calls, replicas, sweeps, executed; int64 [2]
        the largest sweeps and executed; int32 [2] the kernel's per-call
        scratch (zero between calls)."""
        acc = self._acc.get(device)
        if acc is None:
            acc = self._acc[device] = (
                torch.zeros(4, dtype=torch.int64, device=device),
                torch.zeros(2, dtype=torch.int64, device=device),
                torch.zeros(2, dtype=torch.int32, device=device))
        return None if graphs.warming_up() else acc

    def reset(self):
        for sums, maxes, _ in self._acc.values():
            sums.zero_()
            maxes.zero_()

    def add(self, sweeps):
        """Count a call of the twin whose replicas ran ``sweeps`` [...]."""
        acc = self.counted(sweeps.device)
        if acc is None or not sweeps.numel():
            return
        sums, maxes, _ = acc
        executed = sweeps.max()
        sums.add_(torch.stack([torch.ones_like(executed),
                               torch.full_like(executed, sweeps.numel()),
                               sweeps.sum(), executed]))
        torch.maximum(maxes, torch.stack([executed, executed]), out=maxes)

    def summary(self) -> dict:
        calls = replicas = total = executed = peak = peak_exec = 0
        for sums, maxes, _ in self._acc.values():
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


def _relax(sweep, bufs, state, max_iter, threshold, omega):
    """The plain twin's masked Jacobi sweeps on a copy of ``state`` [..., N,
    3]: ``sweep(bufs, state, active, omega)`` applies one update in place
    where ``active`` and returns err [...], measured before the update.
    Every replica starts active, counts the sweeps it is active for and
    stops after the first whose err was within ``threshold``; the loop
    ends when none is active or after ``max_iter`` sweeps. A replica's
    masked sweeps add exact zeros, so each replica's result is its own
    relaxation's. Returns (state, sweeps [...])."""
    state = state.clone()
    batch = state.shape[:-2]
    active = torch.ones(batch, dtype=torch.bool, device=state.device)
    sweeps = torch.zeros(batch, dtype=torch.int64, device=state.device)
    for _ in range(max_iter):
        err = sweep(bufs, state, active, omega)
        sweeps.add_(active)
        active.logical_and_(err > threshold)
        if not bool(active.any()):
            break
    return state, sweeps


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


def _dot3(a, b):
    """[..., C, 1]: a . b over the last axis as ((a0 b0 + a1 b1) + a2 b2)
    on every device, the card's kernel's order (a sum over the axis adds
    in another order on the card)."""
    return (a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2]
            + a[..., 2:3] * b[..., 2:3])


def _scatter_(b, x, update):
    """Apply ``update`` [..., C, 3] to both atoms of every pair of x, in
    place, weighted -1/m_i and +1/m_j (the JAX package's two ``.at[].add``
    in one row sum: an atom in several constraints receives every
    contribution)."""
    add_rows(x, b["plan"], update)


def _shake_sweep(b, x, active, omega):
    d = _pair_diff(b, x)
    diff = _dot3(d, d) - b["d0_sq"]
    denom = b["two_im"] * _dot3(d, b["d_ref"])
    num = diff if omega == 1.0 else omega * diff
    g = num / torch.where(denom.abs() > 1e-12, denom, b["floor"])
    _scatter_(b, x, torch.where(active[..., None, None], g * b["d_ref"],
                                b["zero"]))
    # max |diff| / d0^2 over the constraints (the infinity norm)
    return torch.linalg.vector_norm(diff / b["d0_sq"], float("inf"),
                                    dim=(-2, -1))


def _rattle_sweep(b, v, active, omega):
    vrel = _dot3(_pair_diff(b, v), b["d"])
    k = (vrel if omega == 1.0 else omega * vrel) / b["den"]
    _scatter_(b, v, torch.where(active[..., None, None], k * b["d"],
                                b["zero"]))
    return torch.linalg.vector_norm(vrel, float("inf"), dim=(-2, -1))


def _shake_bufs(cs: ConstraintSet, x_ref, x_new):
    """The tensors the twin's SHAKE sweeps read."""
    b = _pair_tensors(cs)
    b["two_im"] = 2.0 * (b["im_i"] + b["im_j"])
    b["d0_sq"] = (cs.length * cs.length)[:, None]
    b["floor"] = torch.full((), 1e-12, dtype=x_new.dtype,
                            device=x_new.device)
    b["d_ref"] = _pair_diff(b, x_ref)
    return b


def _rattle_bufs(cs: ConstraintSet, x):
    """The tensors the twin's RATTLE sweeps read."""
    b = _pair_tensors(cs)
    d = b["d"] = _pair_diff(b, x)
    b["den"] = (b["im_i"] + b["im_j"]) * _dot3(d, d)
    return b


def shake_plain(cs: ConstraintSet, x_ref, x_new, tol=1e-5, max_iter=150,
                omega=1.0):
    """The plain twin of SHAKE on any device: (positions, sweeps [...])."""
    return _relax(_shake_sweep, _shake_bufs(cs, x_ref, x_new), x_new,
                  max_iter, 2.0 * tol, omega)


def rattle_plain(cs: ConstraintSet, x, v, tol=1e-8, max_iter=100,
                 omega=1.0):
    """The plain twin of RATTLE on any device: (velocities, sweeps
    [...])."""
    return _relax(_rattle_sweep, _rattle_bufs(cs, x), v, max_iter, tol,
                  omega)


def apply_shake(cs: ConstraintSet, x_ref, x_new, tol=1e-5, max_iter=150,
                omega=1.0):
    """Project ``x_new`` [..., N, 3] onto the constraint manifold, moving
    along the directions of ``x_ref`` (the pre-step positions).

    Returns (constrained positions, sweeps [...] per replica). A replica
    stops after the first sweep whose error max |r^2 - d^2| / d^2 was at
    most 2 tol, or after ``max_iter`` sweeps. On the card: one launch of
    the kernel; on the host: the plain twin.
    """
    if cs.num_constraints == 0:
        return x_new, torch.zeros(x_new.shape[:-2], dtype=torch.int64,
                                  device=x_new.device)
    stats = apply_shake.stats
    with trace("omgf.constraint.shake"):
        if x_new.is_cuda:
            return constraint_shake(cs, x_ref, x_new, 2.0 * tol, max_iter,
                                    omega, stats.counted(x_new.device))
        x, sweeps = shake_plain(cs, x_ref, x_new, tol, max_iter, omega)
        stats.add(sweeps)
    return x, sweeps


def apply_rattle(cs: ConstraintSet, x, v, tol=1e-8, max_iter=100,
                 omega=1.0):
    """Remove the velocity components along constrained bonds.

    Returns (velocities, sweeps [...] per replica). A replica stops after
    the first sweep whose error max |(v_i - v_j) . d| was at most ``tol``
    (absolute, nm^2/ps), or after ``max_iter`` sweeps. On the card: one
    launch of the kernel; on the host: the plain twin.
    """
    if cs.num_constraints == 0:
        return v, torch.zeros(v.shape[:-2], dtype=torch.int64,
                              device=v.device)
    stats = apply_rattle.stats
    with trace("omgf.constraint.rattle"):
        if v.is_cuda:
            return constraint_rattle(cs, x, v, tol, max_iter, omega,
                                     stats.counted(v.device))
        v, sweeps = rattle_plain(cs, x, v, tol, max_iter, omega)
        stats.add(sweeps)
    return v, sweeps


apply_shake.stats = SweepStats()
apply_rattle.stats = SweepStats()
