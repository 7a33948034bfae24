"""The yardstick: the card's published peaks, the operations each kernel's
function needs, and the least time each kernel could take.

Frozen copies from ``chip_smoke.py``: the peaks (:94-101), the values
kernel's operation counts (:102-111) and the derivative kernel's (:132-144),
and the arithmetic of ``packed_eval_bound`` (:1018-1048), which here counts
cells and distinct rows with its own indexing instead of calling the
program's ``locate`` / ``cell_index``. The roofline readers in
``gfbench/metrics/`` divide these bounds by the kernels' traced times.

Imports numpy and, for the row count, torch.
"""

from __future__ import annotations

import numpy as np

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
# at the full power limit of 700 W)
H100_FP32_FLOPS = 67e12       # FP32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12    # HBM3
# rsqrt runs on the special-function (MUFU) pipe: 16 results per SM per
# clock against 256 FP32 operations (128 FMA lanes), so 1/16 of the FP32
# peak: 67e12 / 16 = 4.1875e12 results/s
H100_MUFU_PER_S = H100_FP32_FLOPS / 16

# FP32 operations that the values kernel's function needs, with the work
# shared along z (the points of one z-column share dx, dy and dx^2 + dy^2
# for an atom). Per point-atom pair: dz, dz^2 + (dx^2 + dy^2) (2), the
# clamp, the rsqrt (charge) or the reciprocal that gives 1/r^2 (ljr, lja),
# the power (0, 3 or 2 multiplies), the multiply by K and the add into the
# sum. Per column-atom pair: 2 subtractions and 3 for dx^2 + dy^2.
GRIDGEN_OPS_PER_PAIR = {"charge": 7, "ljr": 10, "lja": 9}
GRIDGEN_OPS_PER_COLUMN_ATOM = 5

# FP32 operations per pair that the derivative kernel's function needs,
# every multiply, add, subtract and max counted once (an FMA is two), with
# the work shared: 3 for the displacement, 6 for the clamped r^2, 0 / 4 / 3
# multiplies for 1/r^m by squaring, 1 for K / r^m, 6 for K / r^(m+n) with
# n = 1..6, 15 for the cascade combinations (each folds to one constant of
# the grid type times K / r^(m+n)), 6 direction cosines and squares, 81
# for the 27 terms with every direction product formed once, and 27 to add
# them in.
DERIVS_OPS_PER_PAIR = {"charge": 145, "ljr": 149, "lja": 148}


def k1_bound_s(counts, n_atoms: int, grid_type: str) -> float:
    """Least seconds of one float32 values-kernel launch over a grid of
    ``counts`` points and ``n_atoms`` receptor atoms: the largest of its
    FP32 operations at the FP32 peak, its rsqrt / reciprocal results at
    the MUFU rate, and its bytes (atoms in, points out) at HBM's rate."""
    n_points = int(np.prod(counts))
    pairs = n_points * n_atoms
    columns = counts[0] * counts[1] * n_atoms
    return max((pairs * GRIDGEN_OPS_PER_PAIR[grid_type]
                + columns * GRIDGEN_OPS_PER_COLUMN_ATOM) / H100_FP32_FLOPS,
               pairs / H100_MUFU_PER_S,
               (4 * n_atoms + n_points) * 4 / H100_BYTES_PER_S)


def k2_bound_s(counts, n_atoms: int, grid_type: str) -> float:
    """Least seconds of one float32 derivative-kernel launch: its FP32
    operations at the FP32 peak, against its bytes (atoms in, 27 values a
    point out)."""
    n_points = int(np.prod(counts))
    return max(n_points * n_atoms * DERIVS_OPS_PER_PAIR[grid_type]
               / H100_FP32_FLOPS,
               (4 * n_atoms + 27 * n_points) * 4 / H100_BYTES_PER_S)


def cells_inside(positions, origin, spacing, counts):
    """Flat indices of the cells that the positions [..., 3] inside the box
    fall in, (i * ncy + j) * ncz + k, the cell index clamped to the last
    cell (a point on the box's upper face lies in it)."""
    import torch

    pos = positions.double() - torch.as_tensor(origin, dtype=torch.float64,
                                               device=positions.device)
    n = torch.as_tensor(counts, dtype=torch.float64, device=positions.device)
    h = torch.as_tensor(spacing, dtype=torch.float64, device=positions.device)
    inside = ((pos >= 0) & (pos <= h * (n - 1))).all(-1)
    ijk = torch.floor(pos[inside] / h).long()
    ijk = torch.minimum(ijk, (n - 2).long())
    ncy, ncz = counts[1] - 1, counts[2] - 1
    return (ijk[:, 0] * ncy + ijk[:, 1]) * ncz + ijk[:, 2]


def k3_bound(positions, origin, spacing, counts, degree: int, n_grids: int,
             itemsize: int) -> dict:
    """The least device time of one evaluation of a fused pack at
    ``positions`` [R, N, 3]: the bytes it must move (the distinct rows its
    atoms inside the box read, positions and scalings in, per-atom
    energies and forces out) at HBM's rate, against its FLOPs (per atom
    inside, per grid: 2 FMAs a coefficient for the z sums, 4 a run of d for
    the x-y sums, 20 for the tail; 3 a run once for the x-y weights) at the
    FP32 peak."""
    import torch

    cells = cells_inside(positions, origin, spacing, counts)
    n_in = int(cells.numel())
    distinct = int(torch.unique(cells).numel())
    d, G = degree, n_grids
    row = G * d ** 3 * itemsize
    n_atoms_all = positions.numel() // 3
    rest = (positions.numel() * 2 + G * positions.shape[-2]
            + n_atoms_all) * itemsize
    flops = n_in * (G * (4 * d ** 3 + 8 * d ** 2 + 20) + 3 * d ** 2)
    bounds = {"bytes": (distinct * row + rest) / H100_BYTES_PER_S,
              "operations": flops / H100_FP32_FLOPS}
    bound_by = max(bounds, key=bounds.get)
    return {"atoms_inside": n_in, "distinct_rows": distinct,
            "bytes": distinct * row + rest, "flops": flops,
            "bound_s": bounds[bound_by], "bound_by": bound_by}
