"""The replica ladder's Monte Carlo moves, from their definitions
(AlGDock's BPMF sampler, Minh, J Comput Chem 41:715, 2020):

  ladder      R rungs, geometric from T_min to T_high:
              T_k = T_min (T_high / T_min)^(k / (R - 1)), beta = 1 / (kB T)
  exchange    attempt (i, j), j moved to i's neighbour (i + 1, or i - 1 at
              the top) where it equals i: log_ratio = (beta_i - beta_j)
              (E_i - E_j) of the replicas on the two rungs, accepted where
              log_ratio >= 0 or u < exp(log_ratio); the two swap rungs
  BAT         a spanning tree of the bond graph ordered by mass (the
              z-matrix below): each row (a0, a1, a2, a3) places atom a0 at
              its bond length to a1, angle a0-a1-a2 and torsion
              a0-a1-a2-a3 from atoms placed before it; the first row's a3,
              a2, a1 are the root. A torsion is stored relative to the
              first row that shares its central bond (a1, a2), its
              primary, so that moving a primary torsion turns every atom
              about that bond
  genetic     a (low, high) pair of rungs and a torsion row icut: a
              mutation gives the low rung the high rung's stored torsion
              icut, a crossover its stored torsions icut and after; the
              candidate keeps the low rung's root, bonds and angles.
              log_ratio = -beta_low (E_candidate - E_low), accepted where
              0 <= log_ratio < 30 (crossover) or 50 (mutation), rejected
              at or above, and below 0 accepted where u < exp(log_ratio)

The z-matrix: the root's first atom is the heaviest atom with one bond
(the higher index among equals), its second the first atom bonded to it,
its third the heaviest atom bonded to the second that has more than one
bond (the first listed among equals). Then, over the atoms placed so far
in the order they were placed, each unplaced atom a0 bonded to one a1 of
them, lightest first (lower index among equals), is placed from a1's
lightest placed neighbour a2 other than a0 that has more than one bond
and a2's lightest placed neighbour a3 other than a1; where that a2 has no
such a3, a0 waits. Masses are the System's: repartitioned, in float32.

Departures from the published description: the candidate's root atoms
are placed where the low rung has them (the published code converts them
to external coordinates and back, which returns them up to rounding); a
conversion runs in the reference's arithmetic, its dot and cross
products' operands rounded as a contraction's in the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ligand import BOLTZ, repartitioned_masses

GMC_WINDOW = {True: 30.0, False: 50.0}     # by splice


def temperatures(t_min, t_high, n):
    k = np.arange(n, dtype=np.float64)
    return t_min * (t_high / t_min) ** (k / max(n - 1, 1))


def betas(t_min, t_high, n):
    return 1.0 / (BOLTZ * temperatures(t_min, t_high, n))


def decide(log_ratio, u, window=math.inf):
    """Whether a move is accepted: inside [0, window), or below 0 where the
    uniform ``u`` is below exp(log_ratio); None where a draw is needed and
    ``u`` is None."""
    if not log_ratio < 0:
        return bool(0 <= log_ratio < window)
    if u is None:
        return None
    return bool(u < math.exp(log_ratio))


def robust(log_ratio, u, margin, window=math.inf):
    """The decision at ``log_ratio`` where it is the same anywhere within
    ``margin`` of it, else None."""
    got = {decide(log_ratio + s, u, window) for s in (-margin, 0.0, margin)}
    return got.pop() if len(got) == 1 and None not in got else None


def exchange_partner(i, j, R):
    return (i + 1 if i + 1 < R else i - 1) if i == j else j


def exchange_perm(energies, beta, i, j, u):
    """The permutation [R] (rung r holds the replica from rung perm[r]) and
    the decisions of the attempts (i, j, u) in order, Metropolis on
    ``energies`` [R] of the replicas as they stood."""
    R = len(energies)
    perm = list(range(R))
    accepted = []
    for a, b, uk in zip(i, j, u):
        b = exchange_partner(a, b, R)
        pa, pb = perm[a], perm[b]
        ok = decide((beta[a] - beta[b]) * (energies[pa] - energies[pb]), uk)
        if ok:
            perm[a], perm[b] = pb, pa
        accepted.append(ok)
    return perm, accepted


# ----------------------------------------------------------------------
# Bond-angle-torsion coordinates
# ----------------------------------------------------------------------

def zmatrix(ligand, hydrogen_mass):
    """(rows [n, 4], primary [n]) of the ligand's z-matrix."""
    m = repartitioned_masses(ligand, hydrogen_mass).astype(np.float32)
    m = [float(v) for v in m]
    n = len(m)
    nbr = [[] for _ in range(n)]
    for i, j in np.asarray(ligand.bond_idx).tolist():
        nbr[i].append(j)
        nbr[j].append(i)

    def light(atoms):
        return sorted(atoms, key=lambda a: (m[a], a))

    ends = [a for a in range(n) if len(nbr[a]) == 1]
    first = max(ends, key=lambda a: (m[a], a))
    second = nbr[first][0]
    inner = [a for a in nbr[second] if len(nbr[a]) > 1]
    third = sorted(inner, key=lambda a: -m[a])[0]
    placed = [first, second, third]
    rows = []
    while len(placed) < n:
        grown = False
        for a1 in list(placed):
            for a0 in light(a for a in nbr[a1] if a not in placed):
                a2s = light(a for a in nbr[a1] if a != a0
                            and len(nbr[a]) > 1 and a in placed)
                if not a2s:
                    continue
                a2 = a2s[0]
                a3s = light(a for a in nbr[a2] if a != a1 and a in placed)
                if a3s:
                    rows.append((a0, a1, a2, a3s[0]))
                    placed.append(a0)
                    grown = True
        if not grown:
            raise ValueError("the bond graph has no spanning z-matrix")
    central = [tuple(sorted(r[1:3])) for r in rows]
    return np.asarray(rows), np.asarray([central.index(c) for c in central])


def _cross(ar, a, b):
    return torch.linalg.cross(ar.rnd(a), ar.rnd(b), dim=-1)


def _dot(ar, a, b):
    return (ar.rnd(a) * ar.rnd(b)).sum(-1)


def _unit(ar, a):
    return a / torch.sqrt(_dot(ar, a, a))[..., None]


def _wrap(t):
    return torch.remainder(t + math.pi, 2.0 * math.pi) - math.pi


def internal(x, rows, primary, ar):
    """(bonds, angles, stored torsions) [n] of a conformation x [N, 3]."""
    q0, q1, q2, q3 = (x[rows[:, k]] for k in range(4))
    bonds = torch.sqrt(_dot(ar, q0 - q1, q0 - q1))
    u, w = q0 - q1, q2 - q1
    angles = torch.arccos((_dot(ar, u, w) / torch.sqrt(
        _dot(ar, u, u) * _dot(ar, w, w))).clamp(-1.0, 1.0))
    b1, b2, b3 = q1 - q0, q2 - q1, q3 - q2
    n1, n2 = _cross(ar, b1, b2), _cross(ar, b2, b3)
    raw = torch.atan2(_dot(ar, b1, n2) * torch.sqrt(_dot(ar, b2, b2)),
                      _dot(ar, n1, n2))
    own = torch.as_tensor(primary == np.arange(len(rows)), device=x.device)
    shift = torch.where(own, torch.zeros_like(raw), raw[primary])
    return bonds, angles, _wrap(raw - shift)


def cartesian(root_from, bonds, angles, stored, rows, primary, ar):
    """The conformation [N, 3] of the z-matrix's coordinates, its root
    atoms where ``root_from`` [N, 3] has them."""
    own = torch.as_tensor(primary == np.arange(len(rows)),
                          device=stored.device)
    raw = _wrap(stored + torch.where(own, torch.zeros_like(stored),
                                     stored[primary]))
    atoms = {int(a): root_from[int(a)] for a in rows[0, 1:]}
    for k, (a0, a1, a2, a3) in enumerate(rows.tolist()):
        # a0 at the bond from a1, the angle a0-a1-a2, the torsion
        # a0-a1-a2-a3 (the torsion a3-a2-a1-a0 read backwards)
        c, b, a = atoms[a1], atoms[a2], atoms[a3]
        bc = _unit(ar, c - b)
        n = _unit(ar, _cross(ar, b - a, bc))
        r, th, ph = bonds[k], angles[k], raw[k]
        atoms[a0] = (c - r * torch.cos(th) * bc
                     + r * torch.sin(th) * torch.cos(ph) * _cross(ar, n, bc)
                     + r * torch.sin(th) * torch.sin(ph) * n)
    return torch.stack([atoms[a] for a in range(len(atoms))])


def genetic_candidate(x_low, x_high, splice, icut, rows, primary, ar):
    """The candidate [N, 3] of a genetic move from the low rung's and the
    high rung's conformations [N, 3]."""
    b, a, t_low = internal(x_low, rows, primary, ar)
    _, _, t_high = internal(x_high, rows, primary, ar)
    pick = torch.arange(len(rows), device=t_low.device)
    pick = (pick >= icut) if splice else (pick == icut)
    return cartesian(x_low, b, a, torch.where(pick, t_high, t_low), rows,
                     primary, ar)
