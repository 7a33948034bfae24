"""Bonded energy terms (harmonic bonds/angles, periodic torsions).

OpenMM conventions:
  bonds:    E = k/2 (r - r0)^2
  angles:   E = k/2 (theta - theta0)^2
  torsions: E = k (1 + cos(n phi - phase))

Positions may carry leading batch dimensions, [..., N, 3]; energies are
then [...]. The closed-form forces are assembled with one row sum along
the atom dimension (``ops/scatter.py``: ``index_add_`` on the CPU, a fixed
order on the card; the JAX package's one-hot matmul exists because
scatters are slow on a TPU).
"""

from __future__ import annotations

import torch

from ..ops.lanewise import lanewise
from ..ops.scatter import row_sum, row_sum_plan


def _at(x, col):
    return x[..., col, :]


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _zero_energy(positions):
    return positions.new_zeros(positions.shape[:-2])


def bond_energy(positions, idx, k, r0):
    if idx.shape[0] == 0:
        return _zero_energy(positions)
    d = _at(positions, idx[:, 0]) - _at(positions, idx[:, 1])
    return (0.5 * k * (_norm(d) - r0) ** 2).sum(-1)


def angle_energy(positions, idx, k, t0):
    if idx.shape[0] == 0:
        return _zero_energy(positions)
    a = _at(positions, idx[:, 0]) - _at(positions, idx[:, 1])
    b = _at(positions, idx[:, 2]) - _at(positions, idx[:, 1])
    cos_t = (a * b).sum(-1) / (_norm(a) * _norm(b))
    theta = torch.arccos(cos_t.clamp(-1.0, 1.0))
    return (0.5 * k * (theta - t0) ** 2).sum(-1)


def torsion_energy(positions, idx, k, periodicity, phase):
    if idx.shape[0] == 0:
        return _zero_energy(positions)
    p0, p1, p2, p3 = (_at(positions, idx[:, i]) for i in range(4))
    b1 = p1 - p0
    b2 = p2 - p1
    b3 = p3 - p2
    n1 = _cross(b1, b2)
    n2 = _cross(b2, b3)
    m1 = _cross(n1, b2 / torch.linalg.norm(b2, dim=-1, keepdim=True))
    x = (n1 * n2).sum(-1)
    y = (m1 * n2).sum(-1)
    phi = lanewise(torch.atan2, y, x)
    return (k * (1.0 + torch.cos(periodicity * phi - phase))).sum(-1)


def bonded_energy(positions, system):
    """Sum of all bonded terms for a System."""
    return (bond_energy(positions, system.bond_idx, system.bond_k,
                        system.bond_r0)
            + angle_energy(positions, system.angle_idx, system.angle_k,
                           system.angle_t0)
            + torsion_energy(positions, system.torsion_idx, system.torsion_k,
                             system.torsion_per, system.torsion_phase))


# ----------------------------------------------------------------------
# Closed-form forces (autograd of the energies above is the test oracle)
# ----------------------------------------------------------------------

def assemble_forces(positions, atom_ids, contribs, keys):
    """forces[..., n, :] = sum of contribs[..., k, :] with atom_ids[k] == n.
    ``keys``: the persistent tensors ``atom_ids`` is made from, which key
    its fixed order on the card (``ops/scatter.py``)."""
    plan = row_sum_plan(atom_ids, positions.shape[-2], keys,
                        dtype=contribs.dtype)
    return row_sum(plan, contribs)


# the columns of a term's index whose atoms receive its rows of force, in
# the order its contribs stack them
_ROW_COLUMNS = {2: (0, 1), 3: (0, 2, 1), 4: (0, 1, 2, 3)}


def term_rows(idx):
    """[m K] the atom of each row of force of the K terms ``idx`` [K, m]
    (bonds, angles or torsions), in the order their contribs stack them."""
    return torch.cat([idx[:, c] for c in _ROW_COLUMNS[idx.shape[1]]])


def bonded_rows(system):
    """[2B + 3A + 4T] the atom of each row of the bonded terms' forces, in
    the order ``bonded_energy_forces`` sums them: bonds' first and second
    atoms, angles' first, third and centre atoms, torsions' four atoms."""
    return torch.cat([term_rows(system.bond_idx),
                      term_rows(system.angle_idx),
                      term_rows(system.torsion_idx)])


def _bond_contribs(positions, idx, k, r0):
    d = _at(positions, idx[:, 0]) - _at(positions, idx[:, 1])
    r = _norm(d)
    dr = r - r0
    e = (0.5 * k * dr * dr).sum(-1)
    f_pair = (-k * dr / r)[..., None] * d          # force on atom i
    ids = term_rows(idx)
    contribs = torch.cat([f_pair, -f_pair], dim=-2)
    return e, ids, contribs


def _angle_contribs(positions, idx, k, t0):
    a = _at(positions, idx[:, 0]) - _at(positions, idx[:, 1])
    b = _at(positions, idx[:, 2]) - _at(positions, idx[:, 1])
    na = _norm(a)
    nb = _norm(b)
    ah = a / na[..., None]
    bh = b / nb[..., None]
    cos_t = (ah * bh).sum(-1).clamp(-1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(1e-12))
    e = (0.5 * k * (theta - t0) ** 2).sum(-1)

    # dtheta/da = -(bh - cos*ah) / (|a| sin); grad E = k (theta-t0) dtheta
    coef = (k * (theta - t0) / sin_t)[..., None]
    gi = coef * (bh - cos_t[..., None] * ah) / na[..., None] * -1.0
    gk = coef * (ah - cos_t[..., None] * bh) / nb[..., None] * -1.0
    ids = term_rows(idx)
    contribs = torch.cat([-gi, -gk, gi + gk], dim=-2)
    return e, ids, contribs


def _torsion_contribs(positions, idx, k, periodicity, phase):
    p0, p1, p2, p3 = (_at(positions, idx[:, i]) for i in range(4))
    b1 = p1 - p0
    b2 = p2 - p1
    b3 = p3 - p2
    n1 = _cross(b1, b2)
    n2 = _cross(b2, b3)
    nb2 = _norm(b2)
    m1 = _cross(n1, b2 / nb2[..., None])
    x = (n1 * n2).sum(-1)
    y = (m1 * n2).sum(-1)
    phi = lanewise(torch.atan2, y, x)
    e = (k * (1.0 + torch.cos(periodicity * phi - phase))).sum(-1)

    de_dphi = -k * periodicity * torch.sin(periodicity * phi - phase)
    n1_sq = (n1 * n1).sum(-1).clamp_min(1e-12)
    n2_sq = (n2 * n2).sum(-1).clamp_min(1e-12)
    # sign convention fixed by the atan2(y, x) definition above
    # (m1 = n1 x b2_hat): dphi/dp0 is along +n1, dphi/dp3 along -n2
    dphi_dp0 = (nb2 / n1_sq)[..., None] * n1
    dphi_dp3 = (-nb2 / n2_sq)[..., None] * n2
    c12 = ((b1 * b2).sum(-1) / (nb2 * nb2))[..., None]
    c32 = ((b3 * b2).sum(-1) / (nb2 * nb2))[..., None]
    dphi_dp1 = -(1.0 + c12) * dphi_dp0 + c32 * dphi_dp3
    dphi_dp2 = -dphi_dp0 - dphi_dp1 - dphi_dp3  # translation invariance

    de = de_dphi[..., None]
    ids = term_rows(idx)
    contribs = torch.cat([-de * dphi_dp0, -de * dphi_dp1,
                          -de * dphi_dp2, -de * dphi_dp3], dim=-2)
    return e, ids, contribs


def bond_energy_forces(positions, idx, k, r0):
    if idx.shape[0] == 0:
        return _zero_energy(positions), torch.zeros_like(positions)
    e, ids, contribs = _bond_contribs(positions, idx, k, r0)
    return e, assemble_forces(positions, ids, contribs, (idx,))


def angle_energy_forces(positions, idx, k, t0):
    if idx.shape[0] == 0:
        return _zero_energy(positions), torch.zeros_like(positions)
    e, ids, contribs = _angle_contribs(positions, idx, k, t0)
    return e, assemble_forces(positions, ids, contribs, (idx,))


def torsion_energy_forces(positions, idx, k, periodicity, phase):
    if idx.shape[0] == 0:
        return _zero_energy(positions), torch.zeros_like(positions)
    e, ids, contribs = _torsion_contribs(positions, idx, k, periodicity,
                                         phase)
    return e, assemble_forces(positions, ids, contribs, (idx,))


def bonded_energy_forces(positions, system):
    """Closed-form energy and forces of all bonded terms, assembled with
    one row sum for the whole bonded force."""
    energy = _zero_energy(positions)
    contrib_list = []
    terms = (
        (_bond_contribs, system.bond_idx,
         (system.bond_k, system.bond_r0)),
        (_angle_contribs, system.angle_idx,
         (system.angle_k, system.angle_t0)),
        (_torsion_contribs, system.torsion_idx,
         (system.torsion_k, system.torsion_per, system.torsion_phase)),
    )
    for contribs_fn, idx, params in terms:
        if idx.shape[0]:
            e, _, c = contribs_fn(positions, idx, *params)
            energy = energy + e
            contrib_list.append(c)
    if not contrib_list:
        return energy, torch.zeros_like(positions)
    forces = assemble_forces(positions, bonded_rows(system),
                             torch.cat(contrib_list, dim=-2),
                             (system.bond_idx, system.angle_idx,
                              system.torsion_idx))
    return energy, forces
