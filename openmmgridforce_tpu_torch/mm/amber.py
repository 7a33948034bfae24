"""Minimal AMBER prmtop/inpcrd parser (host-side, NumPy).

A copy of the JAX package's parser: particles with mass/charge/LJ,
harmonic bonds/angles, periodic torsions, 1-2/1-3/1-4 exclusions and
scaled 1-4 exceptions, as ``AmberPrmtopFile.createSystem(
nonbondedMethod=NoCutoff)`` builds them.

All outputs are in MD units (nm, kJ/mol, e, amu, ps) with OpenMM
conventions: AMBER bond/angle constants K (E = K x^2) become OpenMM
k = 2 K (E = k/2 x^2).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from ..units import ANGSTROM_TO_NM, KCAL_TO_KJ

_AMBER_CHARGE_SCALE = 18.2223  # prmtop charges are q * 18.2223


@dataclasses.dataclass
class AmberTopology:
    natom: int
    masses: np.ndarray        # [N] amu
    charges: np.ndarray       # [N] e
    sigmas: np.ndarray        # [N] nm
    epsilons: np.ndarray      # [N] kJ/mol
    atom_names: list
    residue_labels: list
    residue_pointers: np.ndarray
    # bonded terms (OpenMM conventions)
    bond_idx: np.ndarray      # [B, 2] int
    bond_k: np.ndarray        # [B] kJ/mol/nm^2 (E = k/2 (r-r0)^2)
    bond_r0: np.ndarray       # [B] nm
    angle_idx: np.ndarray     # [A, 3]
    angle_k: np.ndarray       # kJ/mol/rad^2 (E = k/2 (t-t0)^2)
    angle_t0: np.ndarray      # rad
    torsion_idx: np.ndarray   # [T, 4]
    torsion_k: np.ndarray     # kJ/mol
    torsion_per: np.ndarray   # periodicity
    torsion_phase: np.ndarray  # rad
    # nonbonded bookkeeping
    exclusions: list          # list of (i, j) with i < j (1-2, 1-3, 1-4)
    pairs14: np.ndarray       # [P, 2] unique 1-4 pairs
    scee: np.ndarray          # [P] electrostatic 1-4 divisors
    scnb: np.ndarray          # [P] LJ 1-4 divisors


def _parse_sections(path):
    sections = {}
    current = None
    fmt_len = None
    is_str = False
    with open(path) as fh:
        for line in fh:
            if line.startswith("%FLAG"):
                current = line.split()[1]
                sections[current] = []
                fmt_len = None
            elif line.startswith("%FORMAT"):
                fmt = line.strip()[8:-1]  # e.g. 5E16.8, 10I8, 20a4
                is_str = "a" in fmt.lower() and "E" not in fmt
                m = re.match(r"(\d+)([aIEFG])([\d.]+)", fmt, re.IGNORECASE)
                if m:
                    fmt_len = int(float(m.group(3).split(".")[0]))
                    is_str = m.group(2).lower() == "a"
            elif line.startswith("%"):
                continue
            elif current is not None:
                raw = line.rstrip("\n")
                if is_str and fmt_len:
                    sections[current].extend(
                        raw[i:i + fmt_len].strip()
                        for i in range(0, len(raw), fmt_len))
                else:
                    sections[current].extend(raw.split())
    return sections


def load_prmtop(path) -> AmberTopology:
    sec = _parse_sections(path)

    def ints(name):
        return np.array([int(x) for x in sec.get(name, [])], dtype=np.int64)

    def floats(name):
        return np.array([float(x) for x in sec.get(name, [])])

    ptr = ints("POINTERS")
    natom = int(ptr[0])
    ntypes = int(ptr[1])

    charges = floats("CHARGE")[:natom] / _AMBER_CHARGE_SCALE
    masses = floats("MASS")[:natom]

    # LJ per-atom parameters from the type tables
    atype = ints("ATOM_TYPE_INDEX")[:natom] - 1
    nb_index = ints("NONBONDED_PARM_INDEX")
    acoef = floats("LENNARD_JONES_ACOEF")
    bcoef = floats("LENNARD_JONES_BCOEF")
    sigmas = np.zeros(natom)
    epsilons = np.zeros(natom)
    for i in range(natom):
        t = atype[i]
        j = int(nb_index[ntypes * t + t]) - 1
        A, B = acoef[j], bcoef[j]
        if A > 0.0 and B > 0.0:
            sigma_a = (A / B) ** (1.0 / 6.0)          # Angstrom
            eps_kcal = B * B / (4.0 * A)
            sigmas[i] = sigma_a * ANGSTROM_TO_NM
            epsilons[i] = eps_kcal * KCAL_TO_KJ
        else:
            sigmas[i] = 0.1  # OpenMM's placeholder 1 A for zero-LJ atoms
            epsilons[i] = 0.0

    # bonds
    bond_k_tab = floats("BOND_FORCE_CONSTANT")
    bond_r0_tab = floats("BOND_EQUIL_VALUE")
    raw_bonds = np.concatenate([ints("BONDS_INC_HYDROGEN"),
                                ints("BONDS_WITHOUT_HYDROGEN")])
    raw_bonds = raw_bonds.reshape(-1, 3)
    bond_idx = raw_bonds[:, :2] // 3
    bt = raw_bonds[:, 2] - 1
    bond_k = 2.0 * bond_k_tab[bt] * KCAL_TO_KJ / (ANGSTROM_TO_NM ** 2)
    bond_r0 = bond_r0_tab[bt] * ANGSTROM_TO_NM

    # angles
    ang_k_tab = floats("ANGLE_FORCE_CONSTANT")
    ang_t0_tab = floats("ANGLE_EQUIL_VALUE")
    raw_ang = np.concatenate([ints("ANGLES_INC_HYDROGEN"),
                              ints("ANGLES_WITHOUT_HYDROGEN")])
    raw_ang = raw_ang.reshape(-1, 4)
    angle_idx = raw_ang[:, :3] // 3
    at = raw_ang[:, 3] - 1
    angle_k = 2.0 * ang_k_tab[at] * KCAL_TO_KJ
    angle_t0 = ang_t0_tab[at]

    # dihedrals
    dk_tab = floats("DIHEDRAL_FORCE_CONSTANT")
    dn_tab = floats("DIHEDRAL_PERIODICITY")
    dp_tab = floats("DIHEDRAL_PHASE")
    scee_tab = floats("SCEE_SCALE_FACTOR")
    scnb_tab = floats("SCNB_SCALE_FACTOR")
    raw_dih = np.concatenate([ints("DIHEDRALS_INC_HYDROGEN"),
                              ints("DIHEDRALS_WITHOUT_HYDROGEN")])
    raw_dih = raw_dih.reshape(-1, 5) if raw_dih.size else \
        np.zeros((0, 5), dtype=np.int64)

    tor_rows = []
    pairs14 = {}
    for (i3, j3, k3, l3, t) in raw_dih:
        i, j = i3 // 3, j3 // 3
        k_at = abs(k3) // 3
        l_at = abs(l3) // 3
        t -= 1
        tor_rows.append((i, j, k_at, l_at, t))
        # negative k flags "do not compute 1-4"; negative l flags improper
        if k3 >= 0 and l3 >= 0:
            a, b = (i, l_at) if i < l_at else (l_at, i)
            if (a, b) not in pairs14:
                scee = scee_tab[t] if len(scee_tab) else 1.2
                scnb = scnb_tab[t] if len(scnb_tab) else 2.0
                pairs14[(a, b)] = (scee if scee != 0 else 1.2,
                                   scnb if scnb != 0 else 2.0)

    if tor_rows:
        tor = np.array(tor_rows, dtype=np.int64)
        torsion_idx = tor[:, :4]
        tt = tor[:, 4]
        torsion_k = dk_tab[tt] * KCAL_TO_KJ
        torsion_per = dn_tab[tt]
        torsion_phase = dp_tab[tt]
    else:
        torsion_idx = np.zeros((0, 4), dtype=np.int64)
        torsion_k = torsion_per = torsion_phase = np.zeros(0)

    # exclusions (1-2, 1-3, 1-4) from the excluded-atoms list
    n_excl = ints("NUMBER_EXCLUDED_ATOMS")[:natom]
    excl_list = ints("EXCLUDED_ATOMS_LIST")
    exclusions = []
    off = 0
    for i in range(natom):
        cnt = int(n_excl[i])
        for e in excl_list[off:off + cnt]:
            j = int(e) - 1
            if j >= 0:
                exclusions.append((min(i, j), max(i, j)))
        off += cnt
    exclusions = sorted(set(exclusions))

    p14 = (np.array(sorted(pairs14.keys()), dtype=np.int64)
           if pairs14 else np.zeros((0, 2), dtype=np.int64))
    scee_arr = np.array([pairs14[tuple(p)][0] for p in p14]) \
        if len(p14) else np.zeros(0)
    scnb_arr = np.array([pairs14[tuple(p)][1] for p in p14]) \
        if len(p14) else np.zeros(0)

    return AmberTopology(
        natom=natom,
        masses=masses,
        charges=charges,
        sigmas=sigmas,
        epsilons=epsilons,
        atom_names=sec.get("ATOM_NAME", [])[:natom],
        residue_labels=sec.get("RESIDUE_LABEL", []),
        residue_pointers=ints("RESIDUE_POINTER"),
        bond_idx=bond_idx,
        bond_k=bond_k,
        bond_r0=bond_r0,
        angle_idx=angle_idx,
        angle_k=angle_k,
        angle_t0=angle_t0,
        torsion_idx=torsion_idx,
        torsion_k=torsion_k,
        torsion_per=torsion_per,
        torsion_phase=torsion_phase,
        exclusions=exclusions,
        pairs14=p14,
        scee=scee_arr,
        scnb=scnb_arr,
    )


def load_inpcrd(path) -> np.ndarray:
    """Coordinates [N, 3] in nm from an AMBER restart/inpcrd file."""
    with open(path) as fh:
        fh.readline()  # title
        natom = int(fh.readline().split()[0])
        vals = []
        for line in fh:
            line = line.rstrip("\n")
            for i in range(0, len(line), 12):
                s = line[i:i + 12].strip()
                if s:
                    vals.append(float(s))
            if len(vals) >= 3 * natom:
                break
    coords = np.array(vals[:3 * natom]).reshape(natom, 3)
    return coords * ANGSTROM_TO_NM
