"""Bond-Angle-Torsion (BAT) internal coordinates.

Re-implementation of the reference's BAT machinery
(example/bat_mda.py:42-264): a mass-ordered spanning-tree z-matrix over the
bond graph, external coordinates of the root triple (origin + polar/
azimuthal/spin angles + two bond lengths and an angle), and phase-shifted
torsions (each torsion is stored relative to the first "primary" torsion
sharing its central bond, so genetic crossover moves whole rotatable-bond
dihedrals coherently).

Layout of a BAT vector for n_torsions = natom - 3:
  [0:3]   root atom origin (first torsion's a3)
  [3:6]   phi, theta, omega — root orientation
  [6:9]   r01, r12, a012 — root internal geometry
  [9:9+n]              bond lengths r(a0, a1)
  [9+n:9+2n]           angles (a0, a1, a2)
  [9+2n:9+3n]          phase-shifted torsions (a0, a1, a2, a3)

The NumPy conversions are a copy of the JAX package's host functions;
``make_torch_converters`` gives their batched torch counterparts, which
the sampler's genetic Monte Carlo runs on the device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["build_zmatrix", "xyz_to_bat", "bat_to_xyz",
           "make_torch_converters"]


def _sorted_by_mass(pairs, reverse=False):
    return sorted(pairs, key=lambda a: (a[1], a[0]), reverse=reverse)


def build_zmatrix(masses, bonds):
    """Spanning-tree z-matrix.

    Args:
      masses: [N] atomic masses.
      bonds: iterable of (i, j) bonded atom pairs.

    Returns:
      (torsions [N-3, 4] int array of (a0, a1, a2, a3) with a0 the new atom,
       primary_torsion_indices [N-3] list: for each torsion, the index of
       the first torsion sharing its central (a1, a2) bond).
    """
    natom = len(masses)
    adj = {i: [] for i in range(natom)}
    for i, j in bonds:
        adj[int(i)].append(int(j))
        adj[int(j)].append(int(i))

    terminal = _sorted_by_mass([(i, masses[i]) for i in adj
                                if len(adj[i]) == 1], reverse=True)
    if not terminal:
        raise ValueError("molecule has no terminal atoms (ring-only graph "
                         "unsupported)")
    initial = terminal[0][0]
    second = adj[initial][0]
    candidates = [(k, masses[k]) for k in adj[second]
                  if (k, masses[k]) not in terminal]
    candidates.sort(key=lambda a: a[1], reverse=True)
    if not candidates:
        raise ValueError("root selection failed: second atom has only "
                         "terminal neighbors")
    third = candidates[0][0]

    root = [initial, second, third]
    selected = list(root)
    torsions = []
    while len(selected) < natom:
        added = False
        for a1 in list(selected):
            for a0, _ in _sorted_by_mass(
                    [(a0, masses[a0]) for a0 in adj[a1]
                     if a0 not in selected]):
                a2_list = _sorted_by_mass(
                    [(a2, masses[a2]) for a2 in adj[a1]
                     if a2 != a0 and len(adj[a2]) > 1 and a2 in selected])
                for a2, _ in a2_list:
                    a3_list = _sorted_by_mass(
                        [(a3, masses[a3]) for a3 in adj[a2]
                         if a3 != a1 and a3 in selected])
                    for a3, _ in a3_list:
                        torsions.append([a0, a1, a2, a3])
                        selected.append(a0)
                        added = True
                        break
                    break
        if not added:
            raise ValueError("spanning tree construction stalled "
                             f"({len(selected)}/{natom} atoms)")

    torsions = np.asarray(torsions)
    central = [tuple(sorted((t[1], t[2]))) for t in torsions]
    primary = [central.index(c) for c in central]
    return torsions, primary


def _distance(p1, p2):
    return float(np.linalg.norm(p2 - p1))


def _angle(p1, p2, p3):
    v1 = p2 - p1
    v2 = p2 - p3
    c = np.dot(v1, v2) / np.sqrt(np.dot(v1, v1) * np.dot(v2, v2))
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _dihedral(p1, p2, p3, p4):
    b1 = p2 - p1
    b2 = p3 - p2
    b3 = p4 - p3
    c1 = np.cross(b2, b3)
    c2 = np.cross(b1, b2)
    y = np.dot(b1, c1) * np.linalg.norm(b2)
    x = np.dot(c1, c2)
    return float(np.arctan2(y, x))


def xyz_to_bat(xyz, torsions, primary):
    """Cartesian [N, 3] -> BAT vector."""
    xyz = np.asarray(xyz, dtype=np.float64)
    a0, a1, a2, a3 = torsions[0]
    p0, p1, p2 = xyz[a3], xyz[a2], xyz[a1]

    v01 = p1 - p0
    v21 = p1 - p2
    r01 = np.linalg.norm(v01)
    r12 = np.linalg.norm(v21)
    a012 = np.arccos(np.clip(np.dot(v01, v21) / (r01 * r12), -1.0, 1.0))

    e = v01 / r01
    phi = np.arctan2(e[1], e[0])
    theta = np.arccos(np.clip(e[2], -1.0, 1.0))
    cp, sp = np.cos(phi), np.sin(phi)
    ct, st = np.cos(theta), np.sin(theta)
    Rz = np.array([[cp * ct, ct * sp, -st],
                   [-sp, cp, 0.0],
                   [cp * st, sp * st, ct]])
    pos2 = Rz @ (p2 - p1)
    omega = np.arctan2(pos2[1], pos2[0])
    root = np.concatenate([p0, [phi, theta, omega, r01, r12, a012]])

    bonds, angles, tors = [], [], []
    for (b0, b1, b2, b3) in torsions:
        bonds.append(_distance(xyz[b0], xyz[b1]))
        angles.append(_angle(xyz[b0], xyz[b1], xyz[b2]))
        tors.append(_dihedral(xyz[b0], xyz[b1], xyz[b2], xyz[b3]))
    tors = np.asarray(tors)

    shift = tors[primary].copy()
    shift[sorted(set(primary))] = 0.0
    tors = ((tors - shift + np.pi) % (2.0 * np.pi)) - np.pi
    return np.concatenate([root, bonds, angles, tors])


def bat_to_xyz(bat_vec, torsions, primary):
    """BAT vector -> Cartesian [N, 3]."""
    bat_vec = np.asarray(bat_vec, dtype=np.float64)
    n = len(torsions)
    origin = bat_vec[:3]
    phi, theta, omega = bat_vec[3:6]
    r01, r12, a012 = bat_vec[6:9]
    bonds = bat_vec[9:9 + n]
    angles = bat_vec[9 + n:9 + 2 * n]
    tors = bat_vec[9 + 2 * n:].copy()

    shift = tors[primary].copy()
    shift[sorted(set(primary))] = 0.0
    tors = ((tors + shift + np.pi) % (2.0 * np.pi)) - np.pi

    p0 = np.zeros(3)
    p1 = np.array([0.0, 0.0, r01])
    p2 = np.array([r12 * np.sin(a012), 0.0, r01 - r12 * np.cos(a012)])
    co, so = np.cos(omega), np.sin(omega)
    Romega = np.array([[co, -so, 0.0], [so, co, 0.0], [0.0, 0.0, 1.0]])
    p2 = Romega @ p2
    cp, sp = np.cos(phi), np.sin(phi)
    ct, st = np.cos(theta), np.sin(theta)
    Re = np.array([[cp * ct, -sp, cp * st],
                   [ct * sp, cp, sp * st],
                   [-st, 0.0, ct]])
    p1 = Re @ p1
    p2 = Re @ p2
    p0 = p0 + origin
    p1 = p1 + origin
    p2 = p2 + origin

    xyz = np.zeros((n + 3, 3))
    a0, a1, a2, a3 = torsions[0]
    xyz[a3], xyz[a2], xyz[a1] = p0, p1, p2

    for (b0, b1, b2, b3), r, ang, tor in zip(torsions, bonds, angles, tors):
        q1, q2, q3 = xyz[b1], xyz[b2], xyz[b3]
        sn_ang, cs_ang = np.sin(ang), np.cos(ang)
        sn_tor, cs_tor = np.sin(tor), np.cos(tor)

        v21 = q1 - q2
        v21 /= np.linalg.norm(v21)
        v32 = q2 - q3
        v32 /= np.linalg.norm(v32)
        vp = np.cross(v32, v21)
        cs = np.dot(v21, v32)
        sn = np.sqrt(max(1.0 - cs * cs, 1e-10))
        vp = vp / sn
        vu = np.cross(vp, v21)
        xyz[b0] = q1 + r * (vu * sn_ang * cs_tor + vp * sn_ang * sn_tor
                            - v21 * cs_ang)
    return xyz


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _rows(*cols):
    """A [..., 3, 3] matrix from three rows, each a list of three [...]
    tensors."""
    return torch.stack([torch.stack(c, -1) for c in cols], -2)


def make_torch_converters(torsions, primary):
    """Torch counterparts of :func:`xyz_to_bat` / :func:`bat_to_xyz` for
    ONE z-matrix, batched over conformations: positions [B, N, 3] <-> BAT
    vectors [B, 9 + 3n] on the inputs' device and in their dtype.

    ``xyz_to_bat`` is vectorised over torsion rows and the batch;
    ``bat_to_xyz`` rebuilds the chain in a loop over the dependency-ordered
    z-matrix, each step placing one atom of every conformation at once.
    Returns ``(xyz_to_bat_fn, bat_to_xyz_fn)``."""
    t = np.asarray(torsions, dtype=np.int64)
    primary = np.asarray(primary, dtype=np.int64)
    n = len(t)
    prim_mask = np.zeros(n, dtype=bool)
    prim_mask[sorted(set(primary.tolist()))] = True
    a0r, a1r, a2r, a3r = (int(v) for v in t[0])
    two_pi = 2.0 * np.pi

    def _shift(tors):
        mask = torch.as_tensor(prim_mask, device=tors.device)
        return torch.where(mask, torch.zeros((), dtype=tors.dtype,
                                             device=tors.device),
                           tors[..., torch.as_tensor(primary,
                                                     device=tors.device)])

    def xyz_to_bat_fn(xyz):
        p0, p1, p2 = xyz[..., a3r, :], xyz[..., a2r, :], xyz[..., a1r, :]
        v01 = p1 - p0
        v21 = p1 - p2
        r01 = _norm(v01)
        r12 = _norm(v21)
        a012 = torch.arccos((_dot(v01, v21) / (r01 * r12)).clamp(-1.0, 1.0))
        e = v01 / r01[..., None]
        phi = torch.atan2(e[..., 1], e[..., 0])
        theta = torch.arccos(e[..., 2].clamp(-1.0, 1.0))
        cp, sp = torch.cos(phi), torch.sin(phi)
        ct, st = torch.cos(theta), torch.sin(theta)
        rz = _rows([cp * ct, ct * sp, -st],
                   [-sp, cp, torch.zeros_like(sp)],
                   [cp * st, sp * st, ct])
        pos2 = (rz @ (p2 - p1)[..., None])[..., 0]
        omega = torch.atan2(pos2[..., 1], pos2[..., 0])
        root = torch.cat([p0, torch.stack([phi, theta, omega, r01, r12,
                                           a012], -1)], -1)

        idx = torch.as_tensor(t, device=xyz.device)
        q0, q1, q2, q3 = (xyz[..., idx[:, k], :] for k in range(4))
        bonds = _norm(q0 - q1)
        w1, w2 = q1 - q0, q1 - q2
        angles = torch.arccos((_dot(w1, w2) / torch.sqrt(
            _dot(w1, w1) * _dot(w2, w2))).clamp(-1.0, 1.0))
        b1, b2, b3 = q1 - q0, q2 - q1, q3 - q2
        c1 = _cross(b2, b3)
        c2 = _cross(b1, b2)
        y = _dot(b1, c1) * _norm(b2)
        x = _dot(c1, c2)
        tors = torch.atan2(y, x)
        tors = torch.remainder(tors - _shift(tors) + np.pi, two_pi) - np.pi
        return torch.cat([root, bonds, angles, tors], -1)

    def bat_to_xyz_fn(bv):
        origin = bv[..., :3]
        phi, theta, omega = bv[..., 3], bv[..., 4], bv[..., 5]
        r01, r12, a012 = bv[..., 6], bv[..., 7], bv[..., 8]
        bonds = bv[..., 9:9 + n]
        angles = bv[..., 9 + n:9 + 2 * n]
        tors0 = bv[..., 9 + 2 * n:]
        tors = torch.remainder(tors0 + _shift(tors0) + np.pi,
                               two_pi) - np.pi

        z = torch.zeros_like(r01)
        p1 = torch.stack([z, z, r01], -1)
        p2 = torch.stack([r12 * torch.sin(a012), z,
                          r01 - r12 * torch.cos(a012)], -1)
        co, so = torch.cos(omega), torch.sin(omega)
        romega = _rows([co, -so, z], [so, co, z],
                       [z, z, torch.ones_like(co)])
        p2 = (romega @ p2[..., None])[..., 0]
        cp, sp = torch.cos(phi), torch.sin(phi)
        ct, st = torch.cos(theta), torch.sin(theta)
        re = _rows([cp * ct, -sp, cp * st], [ct * sp, cp, sp * st],
                   [-st, z, ct])
        p1 = (re @ p1[..., None])[..., 0] + origin
        p2 = (re @ p2[..., None])[..., 0] + origin

        atoms = [None] * (n + 3)
        atoms[a3r], atoms[a2r], atoms[a1r] = origin, p1, p2
        for row, (b0, b1, b2, b3) in enumerate(t.tolist()):
            q1, q2, q3 = atoms[b1], atoms[b2], atoms[b3]
            r, ang, tor = bonds[..., row, None], angles[..., row, None], \
                tors[..., row, None]
            v21 = q1 - q2
            v21 = v21 / _norm(v21)[..., None]
            v32 = q2 - q3
            v32 = v32 / _norm(v32)[..., None]
            vp = _cross(v32, v21)
            cs = _dot(v21, v32)[..., None]
            sn = torch.sqrt((1.0 - cs * cs).clamp_min(1e-10))
            vp = vp / sn
            vu = _cross(vp, v21)
            atoms[b0] = q1 + r * (vu * torch.sin(ang) * torch.cos(tor)
                                  + vp * torch.sin(ang) * torch.sin(tor)
                                  - v21 * torch.cos(ang))
        return torch.stack(atoms, -2)

    return xyz_to_bat_fn, bat_to_xyz_fn
