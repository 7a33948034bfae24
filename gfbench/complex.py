"""The seeded ligand-receptor complex the cells run on, and its grid box.

A frozen copy of ``chip_smoke.py``'s stand-in for the BPMF workload's
AMBER complex (whose files are not in the repository): ``_ELEMENTS``
(chip_smoke.py:260-262), ``_graph_distances`` (:277-295), ``_grow_ligand``
(:298-341) and ``synthetic_complex`` (:344-446), changed to return plain
numpy arrays, so that the plain reference can read the complex without
the program, and in ``_grow_ligand`` so that every seed gives a ligand
that 1000 replicas can step for tens of picoseconds: the heavy elements
are drawn again until their valences hold the hydrogens (some seeds ran
out), and a new atom's direction is drawn from TRIES at once, held to
its parent's bond angles (ANGLE_RANGE) as well as to the distances (grown
at random, some equilibrium angles came out at 170-178 degrees, where the
torsions through them blow replicas up within 50 steps at 1 fs), and
with the ligand's bond graph drawn from a structure seed of the
configuration's, so that every run seed gives the same bonded lists and
the same work. ``grid_box`` differs from chip_smoke.py's
(:449-456): the configuration fixes the point counts, and the box is
centred on the ligand, so that every seed gives the same amount of work.

Imports numpy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# the angles a new bond makes with its parent's bonds, radians: the
# equilibrium angles are the grown geometry's, and a near-linear one lets a
# torsion through it reach its singular force at thermal fluctuations
ANGLE_RANGE = (np.radians(70.0), np.radians(130.0))
# candidate directions a new atom is drawn from
TRIES = 4000

# element -> (mass amu, sigma nm, epsilon kJ/mol, valence)
_ELEMENTS = {"C": (12.011, 0.34, 0.36, 4), "N": (14.007, 0.325, 0.71, 3),
             "O": (15.999, 0.296, 0.88, 2), "H": (1.008, 0.26, 0.066, 1)}


@dataclasses.dataclass(frozen=True)
class Ligand:
    elements: list
    coords: np.ndarray          # [N, 3] nm
    masses: np.ndarray          # [N] amu, before any repartitioning
    charges: np.ndarray         # [N] e
    sigmas: np.ndarray          # [N] nm
    epsilons: np.ndarray        # [N] kJ/mol
    bond_idx: np.ndarray        # [B, 2]
    bond_k: np.ndarray          # kJ/mol/nm^2, E = k/2 (r - r0)^2
    bond_r0: np.ndarray
    angle_idx: np.ndarray       # [A, 3]
    angle_k: np.ndarray         # kJ/mol/rad^2, E = k/2 (t - t0)^2
    angle_t0: np.ndarray
    torsion_idx: np.ndarray     # [T, 4]
    torsion_k: np.ndarray       # E = k (1 + cos(n phi - phase))
    torsion_per: np.ndarray
    torsion_phase: np.ndarray
    exclusions: list            # (i, j): 1-2, 1-3 and 1-4 pairs
    pairs14: np.ndarray         # [P, 2]: 1-4 pairs, scaled
    scee: np.ndarray
    scnb: np.ndarray

    @property
    def natom(self) -> int:
        return len(self.elements)


@dataclasses.dataclass(frozen=True)
class Receptor:
    elements: list
    coords: np.ndarray          # [A, 3] nm
    charges: np.ndarray
    sigmas: np.ndarray
    epsilons: np.ndarray

    @property
    def natom(self) -> int:
        return len(self.elements)


def _graph_distances(n, bonds):
    """All-pairs bond-graph distances (BFS from every atom) [n, n]."""
    nbr = [[] for _ in range(n)]
    for i, j in bonds:
        nbr[i].append(j)
        nbr[j].append(i)
    dist = np.full((n, n), 99, dtype=np.int64)
    for s in range(n):
        dist[s, s] = 0
        frontier = [s]
        while frontier:
            nxt = []
            for a in frontier:
                for b in nbr[a]:
                    if dist[s, b] == 99:
                        dist[s, b] = dist[s, a] + 1
                        nxt.append(b)
            frontier = nxt
    return nbr, dist


def _grow_ligand(rng, n_atoms, graph_rng=None):
    """Atom elements, coordinates [n, 3] nm and bonds of a branched tree:
    heavy atoms first, then hydrogens on free valences. The heavy elements
    are drawn again until their valences can hold every hydrogen; a new
    atom takes the first of TRIES directions that keeps its distances and
    its angles with the parent's bonds (ANGLE_RANGE), or the one that
    falls least short. ``graph_rng`` (default ``rng``) draws the elements
    and the bond graph, ``rng`` the geometry."""
    graph_rng = rng if graph_rng is None else graph_rng
    n_heavy = round(n_atoms * 20 / 47)
    while True:
        elems = ["C"] + list(graph_rng.choice(["C", "C", "C", "C", "N", "O"],
                                              n_heavy - 1))
        room = sum(_ELEMENTS[e][3] for e in elems) - 2 * (n_heavy - 1)
        if room >= n_atoms - n_heavy:
            break
    elems += ["H"] * (n_atoms - n_heavy)
    x = np.zeros((n_atoms, 3))
    bonds, used = [], np.zeros(n_atoms, dtype=np.int64)
    for a in range(1, n_atoms):
        heavy = elems[a] != "H"
        free = [p for p in range(a) if elems[p] != "H"
                and used[p] < _ELEMENTS[elems[p]][3] - (1 if heavy else 0)]
        if not free:
            free = [p for p in range(a) if elems[p] != "H"
                    and used[p] < _ELEMENTS[elems[p]][3]]
        if not free:
            raise ValueError("ligand tree has no free valence left")
        parent = int(graph_rng.choice(free))
        length = 0.15 if heavy else 0.109
        nbr, dist = _graph_distances(a, bonds)
        u = rng.standard_normal((TRIES, 3))
        u /= np.linalg.norm(u, axis=1)[:, None]
        cand = x[parent] + length * u
        # how far each candidate falls short of the distances it needs
        # from the atoms placed (by graph distance) and, at 1 nm a radian,
        # of ANGLE_RANGE with the parent's bonds
        gd = dist[parent, :a] + 1
        is_h = np.array([e == "H" for e in elems[:a]]) | (elems[a] == "H")
        need = np.where(gd <= 1, 0.0, np.where(
            gd == 2, 0.22, np.where(gd == 3, 0.25,
                                    np.where(is_h, 0.28, 0.34))))
        score = (np.linalg.norm(cand[:, None] - x[None, :a], axis=2)
                 - need).min(1)
        for b in nbr[parent]:
            arm = (x[b] - x[parent]) / np.linalg.norm(x[b] - x[parent])
            t = np.arccos(np.clip(u @ arm, -1.0, 1.0))
            score = np.minimum(score, np.minimum(t - ANGLE_RANGE[0],
                                                 ANGLE_RANGE[1] - t))
        ok = np.flatnonzero(score >= 0.0)
        best = cand[ok[0] if ok.size else int(np.argmax(score))]
        x[a] = best
        bonds.append((parent, a))
        used[parent] += 1
        used[a] += 1
    return elems, x, bonds


def synthetic_complex(seed: int, n_ligand: int, n_receptor: int, gap: float,
                      charge_sd: float, density: float = 100.0,
                      structure_seed: int | None = None):
    """A seeded ligand/receptor complex of the BPMF workload's sizes.

    The ligand is an AMBER-like tree of C/N/O/H atoms: bonds, angles and
    proper torsions from the bond graph, 1-2/1-3/1-4 exclusions and 1-4
    pairs scaled by scee 1.2 and scnb 2.0, charges near neutral. The
    receptor is a rigid cloud of atoms at ``density`` atoms/nm^3 in a ball
    around the ligand, every atom at least ``gap`` nm from every ligand
    atom, with charges of standard deviation ``charge_sd`` e.
    ``structure_seed`` (default ``seed``) draws the ligand's elements and
    bond graph, and so its bonds, angles, torsions and pairs; ``seed``
    draws the rest.

    Returns (Ligand, Receptor).
    """
    rng = np.random.default_rng(seed)
    graph_rng = (None if structure_seed is None
                 else np.random.default_rng(structure_seed))
    elems, x, bonds = _grow_ligand(rng, n_ligand, graph_rng)
    n = n_ligand
    nbr, dist = _graph_distances(n, bonds)
    params = np.array([_ELEMENTS[e][:3] for e in elems])
    charges = np.where(np.array(elems) == "H", 0.12, -0.1) \
        + 0.15 * rng.standard_normal(n)
    charges -= charges.mean()

    bond_idx = np.array(bonds, dtype=np.int64)
    bond_r0 = np.linalg.norm(x[bond_idx[:, 0]] - x[bond_idx[:, 1]], axis=1)
    has_h = np.array([elems[i] == "H" or elems[j] == "H" for i, j in bonds])
    bond_k = np.where(has_h, 284512.0, 251040.0)

    angles = [(i, j, k) for j in range(n) for i in nbr[j] for k in nbr[j]
              if i < k]
    angle_idx = np.array(angles, dtype=np.int64).reshape(-1, 3)
    a = x[angle_idx[:, 0]] - x[angle_idx[:, 1]]
    b = x[angle_idx[:, 2]] - x[angle_idx[:, 1]]
    angle_t0 = np.arccos(np.clip(
        (a * b).sum(1) / np.linalg.norm(a, axis=1)
        / np.linalg.norm(b, axis=1), -1.0, 1.0))
    angle_k = np.full(len(angles), 418.4)

    torsions = [(i, j, k, l) for j, k in bonds for i in nbr[j] if i != k
                for l in nbr[k] if l != j]
    torsion_idx = np.array(torsions, dtype=np.int64).reshape(-1, 4)
    nt = len(torsions)
    torsion_k = rng.uniform(0.5, 4.0, nt)
    torsion_per = rng.integers(1, 4, nt).astype(np.float64)
    torsion_phase = np.where(rng.random(nt) < 0.5, 0.0, np.pi)

    iu, ju = np.triu_indices(n, k=1)
    near = dist[iu, ju] <= 3
    exclusions = [(int(i), int(j)) for i, j in zip(iu[near], ju[near])]
    is14 = dist[iu, ju] == 3
    pairs14 = np.stack([iu[is14], ju[is14]], axis=1).astype(np.int64)

    lig = Ligand(
        elements=list(elems), coords=x, masses=params[:, 0],
        charges=charges, sigmas=params[:, 1], epsilons=params[:, 2],
        bond_idx=bond_idx, bond_k=bond_k, bond_r0=bond_r0,
        angle_idx=angle_idx, angle_k=angle_k, angle_t0=angle_t0,
        torsion_idx=torsion_idx, torsion_k=torsion_k,
        torsion_per=torsion_per, torsion_phase=torsion_phase,
        exclusions=exclusions, pairs14=pairs14,
        scee=np.full(len(pairs14), 1.2), scnb=np.full(len(pairs14), 2.0))

    # receptor: uniform at the density in a ball around the ligand, minus
    # a ``gap`` envelope around every ligand atom
    center = x.mean(0)
    r_out = (3.0 * (n_receptor / density + 4.0) / (4.0 * np.pi)) ** (1 / 3) \
        + np.linalg.norm(x - center, axis=1).max()
    rec = np.zeros((0, 3))
    while len(rec) < n_receptor:
        u = rng.standard_normal((4 * n_receptor, 3))
        u *= (r_out * rng.random(len(u)) ** (1 / 3)
              / np.linalg.norm(u, axis=1))[:, None]
        cand = center + u
        dmin = np.linalg.norm(cand[:, None, :] - x[None], axis=2).min(1)
        rec = np.concatenate([rec, cand[dmin >= gap]])
    rec = rec[:n_receptor]
    rel = rng.choice(["C", "C", "N", "O", "H", "H"], n_receptor)
    rparams = np.array([_ELEMENTS[e][:3] for e in rel])
    rq = charge_sd * rng.standard_normal(n_receptor)
    rq -= rq.mean()
    receptor = Receptor(elements=list(rel), coords=rec, charges=rq,
                        sigmas=rparams[:, 1], epsilons=rparams[:, 2])
    return lig, receptor


def from_config(config: dict, seed: int):
    """The complex a configuration describes, drawn from ``seed``."""
    c = config["complex"]
    return synthetic_complex(seed, c["ligand_atoms"], c["receptor_atoms"],
                             c["gap_nm"], c["charge_sd_e"],
                             c["receptor_density_per_nm3"],
                             c["ligand_structure_seed"])


def grid_box(ligand_coords, counts, spacing):
    """The origin of a box of ``counts`` points at ``spacing`` nm centred
    on the ligand's bounds."""
    centre = 0.5 * (ligand_coords.min(0) + ligand_coords.max(0))
    half = 0.5 * spacing * (np.asarray(counts, np.float64) - 1.0)
    return tuple(float(v) for v in centre - half)
