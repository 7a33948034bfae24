"""Langevin dynamics with holonomic bond constraints, from their
definitions:

  constraints  the bonds that hold a hydrogen (an atom lighter than 2 amu
               before any repartitioning: OpenMM's HBonds), each at its
               equilibrium length d; they leave the harmonic bond terms
  SHAKE        after the position update, the new positions x' move along
               the bond vectors r_c = x_i - x_j of the step's start:
               x'_i -= lambda_c r_c / m_i, x'_j += lambda_c r_c / m_j for
               every constraint c = (i, j), with the multipliers lambda
               that put every |x'_i - x'_j| at its d
  RATTLE       after SHAKE, v_i -= mu_c d_c / m_i, v_j += mu_c d_c / m_j
               with d_c = x'_i - x'_j, with the multipliers mu that make
               every (v_i - v_j) . d_c zero
  step         the classic Langevin update of ``ligand.py`` (v, then
               x' = x + v dt), SHAKE, the move folded into the velocities
               (v += (x'' - x') / dt), then RATTLE

SHAKE's multipliers come from Newton's method on the C equations
|x'_i - x'_j|^2 = d^2, each iteration one linear solve, until every
|r^2 - d^2| / d^2 is at most 1e-13 (float64); RATTLE's from one linear
solve, since its conditions are linear in mu. Each replica is solved at
once over all of its constraints.

Departures from the published description: SHAKE and RATTLE were
published as iterations over one constraint at a time to a tolerance; here
each is solved to the precision of the arithmetic, so the reference lies on
the constraint manifold the iterations approach. The program stops its
sweeps at its tolerances (1e-5 relative on positions, 1e-8 nm^2/ps on
velocities), and that difference is part of what the readings measure.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ligand import BOLTZ

# SHAKE's Newton iterations stop once every |r^2 - d^2| / d^2 is at most
# this (float64), or after NEWTON_MAX iterations (the control's float32
# stops there, at the noise of its arithmetic)
NEWTON_TOL = 1e-13
NEWTON_MAX = 30


def hbond_constraints(ligand):
    """(pairs [C, 2], lengths [C]) of the bonds that hold a hydrogen, by
    the ligand's masses before any repartitioning."""
    m = np.asarray(ligand.masses, np.float64)
    is_h = (m > 0.0) & (m < 2.0)
    idx = np.asarray(ligand.bond_idx, np.int64).reshape(-1, 2)
    keep = is_h[idx[:, 0]] | is_h[idx[:, 1]]
    return idx[keep], np.asarray(ligand.bond_r0, np.float64)[keep]


def without_constrained_bonds(model, ligand):
    """``model`` (a ``ligand.LigandModel``) with the constrained bonds
    taken out of its harmonic bond terms, as OpenMM's createSystem does."""
    idx, k, r0 = model.bonds
    pairs, _ = hbond_constraints(ligand)
    held = {tuple(sorted(p)) for p in pairs.tolist()}
    keep = torch.as_tensor([tuple(sorted(b)) not in held
                            for b in idx.tolist()], device=idx.device)
    model.bonds = (idx[keep], k[keep], r0[keep])
    return model


class Constraints:
    """The constraint set in arithmetic ``ar``: the coupling K = B M^-1 B^T
    [C, C] of the constraints through their shared atoms, B [C, N] the
    signed incidence (+1 at i, -1 at j)."""

    def __init__(self, pairs, lengths, masses, ar, device):
        self.ar = ar
        t = dict(dtype=ar.dtype, device=device)
        n = len(masses)
        B = np.zeros((len(pairs), n))
        B[np.arange(len(pairs)), pairs[:, 0]] = 1.0
        B[np.arange(len(pairs)), pairs[:, 1]] = -1.0
        inv_m = 1.0 / np.asarray(masses, np.float64)
        self.B = torch.as_tensor(B, **t)
        self.inv_m = torch.as_tensor(inv_m, **t)
        self.K = torch.as_tensor(B @ np.diag(inv_m) @ B.T, **t)
        self.d_sq = torch.as_tensor(np.asarray(lengths) ** 2, **t)
        self.lengths = torch.as_tensor(lengths, **t)

    def dot(self, a, b):
        """a . b over the last axis, its operands as the arithmetic takes
        a contraction's."""
        return (self.ar.rnd(a) * self.ar.rnd(b)).sum(-1)

    def bond_vectors(self, x):
        """x_i - x_j [..., C, 3]."""
        return torch.einsum("cn,...nk->...ck", self.B, x)

    def _moved(self, x, lam, r):
        """x - M^-1 B^T (lam r): every constraint's multiple of its
        direction r [..., C, 3], weighted by the inverse masses."""
        return x - self.inv_m[:, None] * torch.einsum(
            "cn,...c,...ck->...nk", self.B, lam, r)

    def shake(self, x_ref, x_new):
        """Positions x_new [..., N, 3] moved onto the constraints along the
        bond vectors of x_ref."""
        r = self.bond_vectors(x_ref)
        d_new = self.bond_vectors(x_new)
        lam = torch.zeros(r.shape[:-1], dtype=r.dtype, device=r.device)
        for _ in range(NEWTON_MAX):
            d = d_new - torch.einsum("cd,...d,...dk->...ck", self.K, lam, r)
            f = self.dot(d, d) - self.d_sq
            if float((f / self.d_sq).abs().max()) <= NEWTON_TOL:
                break
            # df_c / dlam_e = -2 K_ce (d_c . r_e)
            J = -2.0 * self.K * self.dot(d[..., :, None, :],
                                         r[..., None, :, :])
            lam = lam - torch.linalg.solve(J, f)
        return self._moved(x_new, lam, r)

    def rattle(self, x, v):
        """Velocities v [..., N, 3] with no component along the
        constrained bonds of x."""
        d = self.bond_vectors(x)
        # (B v)_c . d_c - sum_e K_ce mu_e (d_e . d_c) = 0
        A = self.K * self.dot(d[..., :, None, :], d[..., None, :, :])
        b = self.dot(self.bond_vectors(v), d)
        mu = torch.linalg.solve(A, b)
        return self._moved(v, mu, d)

    def violation(self, x):
        """The widest |r / d - 1| [...] over the constraints of x."""
        r = self.bond_vectors(x.to(self.lengths.dtype)).norm(dim=-1)
        return (r / self.lengths - 1.0).abs().amax(-1)


def follow(model, field, cons, x0, v0, noise, dt, friction, temperatures,
           stored=None):
    """Positions and velocities after ``noise.shape[0]`` constrained
    Langevin steps from (x0, v0) [R, N, 3], each replica at its own
    temperature (``temperatures`` [R] K), with per-step noise
    [S, R, N, 3]. ``stored``: a dtype the state is rounded to after every
    step (what storing it in that precision alone does to a trajectory)."""
    dt_ = model.ar.dtype
    x, v = x0.to(dt_), v0.to(dt_)
    temps = torch.as_tensor(temperatures, dtype=dt_,
                            device=x.device)[:, None, None]
    m = model.masses[:, None]
    a = math.exp(-friction * dt)
    for s in range(noise.shape[0]):
        f = model.forces(x, field.energy)
        v = (a * v + (1.0 - a) * f / (m * friction)
             + torch.sqrt(BOLTZ * temps * (1.0 - a * a) / m)
             * noise[s].to(dt_))
        x_new = x + v * dt
        x_c = cons.shake(x, x_new)
        v = cons.rattle(x_c, v + (x_c - x_new) / dt)
        x = x_c
        if stored is not None:
            x, v = x.to(stored).to(dt_), v.to(stored).to(dt_)
    return x, v
