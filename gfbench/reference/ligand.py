"""The ligand's force field and the Langevin update, from their
definitions (OpenMM's conventions):

  bonds      E = k/2 (r - r0)^2
  angles     E = k/2 (theta - theta0)^2
  torsions   E = k (1 + cos(n phi - phase))
  pairs      i < j not excluded (1-2, 1-3 and 1-4 pairs), Coulomb
             138.935456 qi qj / r + 4 eps ((sigma/r)^12 - (sigma/r)^6),
             sigma the mean, eps the geometric mean; 1-4 pairs again with
             the charge product over scee and eps over scnb
  grids      each grid: its scaling times its interpolated value, for atoms
             inside the box with a scaling other than 0; an atom outside
             the box takes k_oob/2 d^2 once, d its distance to the box
  masses     hydrogens raised to the configuration's mass, the difference
             taken from the heavy atom each is bonded to
  Langevin   a = exp(-gamma dt); v <- a v + (1 - a) f / (m gamma)
             + sqrt(kB T (1 - a^2) / m) xi; x <- x + v dt

Forces are the negative gradient of the energy (autograd).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import fields, interp

COULOMB = fields.COULOMB
BOLTZ = 0.00831446261815324    # kJ / (mol K)


def repartitioned_masses(ligand, hydrogen_mass):
    m = np.array(ligand.masses, dtype=np.float64)
    is_h = (m > 0.0) & (m < 2.0)
    for i, j in ligand.bond_idx:
        if is_h[i] != is_h[j]:
            h, heavy = (i, j) if is_h[i] else (j, i)
            delta = hydrogen_mass - m[h]
            m[h] += delta
            m[heavy] -= delta
    return m


class LigandModel:
    """The ligand's energy in arithmetic ``ar`` on ``device``, with a grid
    term from ``grid_energy(x) -> [...]`` (or none)."""

    def __init__(self, ligand, hydrogen_mass, ar, device):
        self.ar = ar
        t = dict(dtype=ar.dtype, device=device)

        def f(a):
            return torch.as_tensor(np.asarray(a, np.float64), **t)

        def i(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        self.masses = f(repartitioned_masses(ligand, hydrogen_mass))
        self.bonds = (i(ligand.bond_idx), f(ligand.bond_k),
                      f(ligand.bond_r0))
        self.angles = (i(ligand.angle_idx), f(ligand.angle_k),
                       f(ligand.angle_t0))
        self.torsions = (i(ligand.torsion_idx), f(ligand.torsion_k),
                         f(ligand.torsion_per), f(ligand.torsion_phase))
        n = ligand.natom
        q = np.asarray(ligand.charges, np.float64)
        sig = np.asarray(ligand.sigmas, np.float64)
        eps = np.asarray(ligand.epsilons, np.float64)
        qq = np.outer(q, q)
        sg = 0.5 * (sig[:, None] + sig[None, :])
        ep = np.sqrt(np.outer(eps, eps))
        live = np.triu(np.ones((n, n)), k=1)
        for a, b in ligand.exclusions:
            live[min(a, b), max(a, b)] = 0.0
        for p, (a, b) in enumerate(ligand.pairs14):
            a, b = min(a, b), max(a, b)
            qq[a, b] /= ligand.scee[p]
            ep[a, b] /= ligand.scnb[p]
            live[a, b] = 1.0
        self.pairs = (f(qq), f(sg), f(ep), torch.as_tensor(live > 0,
                                                          device=device))

    def bonded_and_pairs(self, x):
        idx, k, r0 = self.bonds
        r = (x[..., idx[:, 0], :] - x[..., idx[:, 1], :]).norm(dim=-1)
        e = (0.5 * k * (r - r0) ** 2).sum(-1)

        idx, k, t0 = self.angles
        a = x[..., idx[:, 0], :] - x[..., idx[:, 1], :]
        b = x[..., idx[:, 2], :] - x[..., idx[:, 1], :]
        cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
        theta = torch.acos(cos.clamp(-1.0, 1.0))
        e = e + (0.5 * k * (theta - t0) ** 2).sum(-1)

        idx, k, per, phase = self.torsions
        b1 = x[..., idx[:, 1], :] - x[..., idx[:, 0], :]
        b2 = x[..., idx[:, 2], :] - x[..., idx[:, 1], :]
        b3 = x[..., idx[:, 3], :] - x[..., idx[:, 2], :]
        n1 = torch.linalg.cross(b1, b2, dim=-1)
        n2 = torch.linalg.cross(b2, b3, dim=-1)
        y = (b2.norm(dim=-1, keepdim=True) * b1 * n2).sum(-1)
        phi = torch.atan2(y, (n1 * n2).sum(-1))
        e = e + (k * (1.0 + torch.cos(per * phi - phase))).sum(-1)

        qq, sg, ep, live = self.pairs
        d = x[..., :, None, :] - x[..., None, :, :]
        r2 = torch.where(live, (d * d).sum(-1), torch.ones_like(d[..., 0]))
        inv_r = torch.rsqrt(r2)
        s6 = (sg * sg / r2) ** 3
        pair = COULOMB * qq * inv_r + 4.0 * ep * (s6 * s6 - s6)
        return e + torch.where(live, pair, torch.zeros_like(pair)).sum((-2,
                                                                        -1))

    def forces(self, x, grid_energy=None):
        """-dE/dx [..., N, 3] at positions [..., N, 3]."""
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            e = self.bonded_and_pairs(x)
            if grid_energy is not None:
                e = e + grid_energy(x)
            (g,) = torch.autograd.grad(e.sum(), x)
        return -g

    def langevin(self, x, v, f, noise, dt, friction, temperature):
        """One classic Langevin step."""
        m = self.masses[:, None]
        a = math.exp(-friction * dt)
        v = (a * v + (1.0 - a) * f / (m * friction)
             + torch.sqrt(BOLTZ * temperature * (1.0 - a * a) / m) * noise)
        return x + v * dt, v


class GridField:
    """The grid term of the energy, for grids of one kind on one box: a
    cache of the grid data at the points the atoms' cells read, filled
    from the receptor as new points are read."""

    def __init__(self, kind, counts, origin, spacing, grid_types, receptor,
                 cap, oob_k, scaling, ar, device):
        self.kind = kind                # "values" or "derivatives"
        self.counts, self.origin, self.spacing = counts, origin, spacing
        self.grid_types, self.receptor = grid_types, receptor
        self.cap, self.oob_k, self.ar = cap, oob_k, ar
        self.scaling = torch.as_tensor(scaling, dtype=ar.dtype,
                                       device=device)     # [G, N]
        n_points = int(np.prod(counts))
        self.have = torch.zeros(n_points, dtype=torch.bool, device=device)
        tail = (len(grid_types),) + ((3, 3, 3) * (kind == "derivatives"))
        self.data = torch.zeros((n_points,) + tail, dtype=ar.dtype,
                                device=device)

    def fill(self, flat):
        need = torch.unique(flat.reshape(-1))
        need = need[~self.have[need]]
        if need.numel():
            self.data[need] = fields.grid_data(
                self.kind, need, self.counts, self.origin, self.spacing,
                self.grid_types, self.receptor, self.cap, self.ar)
            self.have[need] = True

    def values(self, x):
        """Interpolated values [..., N, G] and inside [..., N] of atoms at
        x [..., N, 3]."""
        inside, cell, frac = interp.locate(x, self.origin, self.spacing,
                                           self.counts)
        if self.kind == "values":
            pts = interp.bspline_points(cell, self.counts)
            self.fill(pts)
            vals = self.data[pts].movedim(-1, -4)      # [..., G, 4, 4, 4]
            return interp.bspline_value(vals, frac, self.ar), inside
        pts = interp.corner_points(cell, self.counts)
        self.fill(pts)
        D = self.data[pts].movedim(-4, -7)          # [..., G, 2,2,2,3,3,3]
        return interp.hermite_value(D, frac, self.ar), inside

    def energy(self, x):
        """[...] grid energy of positions [..., N, 3]: the scaled
        interpolated values of atoms inside the box, the restraint
        outside."""
        vals, inside = self.values(x)
        s = self.scaling.transpose(0, 1)                  # [N, G]
        active = inside[..., None] & (s != 0)
        e = torch.where(active, s * vals, torch.zeros_like(vals)).sum(-1)
        o = torch.as_tensor(self.origin, dtype=x.dtype, device=x.device)
        hi = o + torch.as_tensor(self.spacing, dtype=x.dtype,
                                 device=x.device) * (
            torch.as_tensor(self.counts, device=x.device) - 1).to(x.dtype)
        dev = x - torch.minimum(torch.maximum(x, o), hi)
        e = e + 0.5 * self.oob_k * (dev * dev).sum(-1)
        return e.sum(-1)
