"""Dense intra-ligand nonbonded interactions (Coulomb + Lennard-Jones).

Pair parameters (Lorentz-Berthelot combination, exclusions zeroed,
exceptions overridden) are precomputed on the host into dense [N, N]
tables once; evaluation is a masked broadcast over the pair matrix,
batched over any leading dimensions of the positions ([R, N, 3] for
replicas).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..units import COULOMB_CONST


@dataclasses.dataclass(frozen=True)
class PairTable:
    """Precomputed dense pair parameters for one template ligand."""

    qq: torch.Tensor        # [N, N] charge products (1-4 scaling applied)
    sigma: torch.Tensor     # [N, N] combined sigma
    epsilon: torch.Tensor   # [N, N] combined epsilon (1-4 scaling applied)
    mask: torch.Tensor      # [N, N] 1.0 for interacting i<j pairs else 0.0


def build_pair_table(charges, sigmas, epsilons, exclusions=(),
                     exceptions=(), dtype=torch.float64,
                     device=None) -> PairTable:
    """Build the dense pair table (on the host in float64, then moved to
    ``device``, the CUDA card by default).

    Args:
      charges, sigmas, epsilons: [N] per-atom parameters.
      exclusions: iterable of (i, j) pairs to remove entirely.
      exceptions: iterable of (i, j, chargeProd, sigma, epsilon) overriding
        the combination rule (1-4 interactions). An exception pair is
        evaluated even if also listed as excluded.
    """
    device = resolve_device(device)
    charges = np.asarray(charges, dtype=np.float64)
    sigmas = np.asarray(sigmas, dtype=np.float64)
    epsilons = np.asarray(epsilons, dtype=np.float64)
    n = len(charges)

    qq = np.outer(charges, charges)
    sigma = 0.5 * (sigmas[:, None] + sigmas[None, :])
    epsilon = np.sqrt(np.outer(epsilons, epsilons))

    mask = np.triu(np.ones((n, n)), k=1)
    for (i, j) in exclusions:
        mask[min(i, j), max(i, j)] = 0.0
    for (i, j, cp, sg, ep) in exceptions:
        a, b = min(i, j), max(i, j)
        qq[a, b] = qq[b, a] = cp
        sigma[a, b] = sigma[b, a] = sg
        epsilon[a, b] = epsilon[b, a] = ep
        mask[a, b] = 1.0 if (cp != 0.0 or ep != 0.0) else 0.0

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return PairTable(qq=t(qq), sigma=t(sigma), epsilon=t(epsilon),
                     mask=t(mask))


def pair_energy_forces(table: PairTable, positions):
    """Total pair energy [...] and forces [..., N, 3] of positions
    [..., N, 3]."""
    x = positions.to(table.qq.dtype)
    dr = x[..., :, None, :] - x[..., None, :, :]     # [..., N, N, 3] (i - j)
    r2 = (dr * dr).sum(-1)
    live = table.mask > 0
    r2_safe = torch.where(live, r2, torch.ones_like(r2))
    inv_r = torch.rsqrt(r2_safe)
    inv_r2 = inv_r * inv_r

    coul = COULOMB_CONST * table.qq * inv_r
    sig_r2 = (table.sigma * table.sigma) * inv_r2
    sig_r6 = sig_r2 * sig_r2 * sig_r2
    sig_r12 = sig_r6 * sig_r6
    lj = 4.0 * table.epsilon * (sig_r12 - sig_r6)

    pair_e = table.mask * (coul + lj)
    energy = pair_e.sum((-2, -1))

    # -dE/dr along dr: F_i += fmag * dr_hat, F_j -= ...
    fmag_over_r = table.mask * (
        coul + 4.0 * table.epsilon * (12.0 * sig_r12 - 6.0 * sig_r6)
    ) * inv_r2
    fvec = fmag_over_r[..., None] * dr            # force on i from j (i<j)
    forces = fvec.sum(-2) - fvec.sum(-3)
    return energy, forces


def pair_energy(table: PairTable, positions):
    return pair_energy_forces(table, positions)[0]
