"""Port AMBER parsing, bonded and pair forces, System construction and the
total energy/force function vs the JAX package (float64, CPU), plus the
closed-form forces vs torch.autograd of the port's own energies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from openmmgridforce_tpu.grid import Grid as JGrid
from openmmgridforce_tpu.mm import amber as jamber
from openmmgridforce_tpu.mm import forcefield as jff
from openmmgridforce_tpu.mm import system as jsystem
from openmmgridforce_tpu.ops import packed as jpacked
from openmmgridforce_tpu.ops import pairwise as jpairwise
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.mm import amber, forcefield, system
from openmmgridforce_tpu_torch.ops import packed, pairwise

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ligand():
    lig, x, _, _ = chip_smoke.synthetic_complex(7, n_ligand=21,
                                                n_receptor=10)
    return lig, x


# ----------------------------------------------------------------------
# A minimal prmtop/inpcrd writer (AMBER units) for the parser round trip
# ----------------------------------------------------------------------

def _section(name, fmt, values):
    per, width, kind = {"E": (5, 16, "E"), "I": (10, 8, "I"),
                        "a": (20, 4, "a")}[fmt]
    spec = {"E": "5E16.8", "I": "10I8", "a": "20a4"}[fmt]
    lines = [f"%FLAG {name}", f"%FORMAT({spec})"]
    cells = []
    for v in values:
        if kind == "E":
            cells.append(f"{v:16.8E}")
        elif kind == "I":
            cells.append(f"{int(v):8d}")
        else:
            cells.append(f"{v:<4s}"[:4])
    for i in range(0, max(len(cells), 1), per):
        lines.append("".join(cells[i:i + per]))
    return lines


def write_prmtop(path, top):
    n = top.natom
    kcal, ang = 4.184, 0.1
    acoef, bcoef, nb_index = [], [], np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for j in range(i + 1):
            sig = 0.5 * (top.sigmas[i] + top.sigmas[j]) / ang
            eps = np.sqrt(top.epsilons[i] * top.epsilons[j]) / kcal
            acoef.append(4.0 * eps * sig ** 12)
            bcoef.append(4.0 * eps * sig ** 6)
            nb_index[i, j] = nb_index[j, i] = len(acoef)
    # one 1-4 torsion per (i, l) pair; repeats of a pair skip the 1-4 (-k)
    seen, dih = set(), []
    for t, (i, j, k, l) in enumerate(top.torsion_idx):
        key = (min(i, l), max(i, l))
        kk = 3 * k if key not in seen else -3 * k
        seen.add(key)
        dih += [3 * i, 3 * j, kk, 3 * l, t + 1]
    excl_n, excl = [], []
    for i in range(n):
        js = sorted(j for (a, j) in top.exclusions if a == i)
        excl_n.append(max(len(js), 1))
        excl += [j + 1 for j in js] or [0]
    lines = ["%VERSION  VERSION_STAMP = V0001.000"]
    lines += _section("TITLE", "a", ["LIG"])
    lines += _section("POINTERS", "I", [n, n] + [0] * 29)
    lines += _section("ATOM_NAME", "a", top.atom_names)
    lines += _section("CHARGE", "E", top.charges * 18.2223)
    lines += _section("MASS", "E", top.masses)
    lines += _section("ATOM_TYPE_INDEX", "I", range(1, n + 1))
    lines += _section("NUMBER_EXCLUDED_ATOMS", "I", excl_n)
    lines += _section("NONBONDED_PARM_INDEX", "I", nb_index.reshape(-1))
    lines += _section("RESIDUE_LABEL", "a", ["LIG"])
    lines += _section("RESIDUE_POINTER", "I", [1])
    lines += _section("BOND_FORCE_CONSTANT", "E",
                      top.bond_k / (2.0 * kcal) * ang ** 2)
    lines += _section("BOND_EQUIL_VALUE", "E", top.bond_r0 / ang)
    lines += _section("ANGLE_FORCE_CONSTANT", "E", top.angle_k / (2 * kcal))
    lines += _section("ANGLE_EQUIL_VALUE", "E", top.angle_t0)
    lines += _section("DIHEDRAL_FORCE_CONSTANT", "E", top.torsion_k / kcal)
    lines += _section("DIHEDRAL_PERIODICITY", "E", top.torsion_per)
    lines += _section("DIHEDRAL_PHASE", "E", top.torsion_phase)
    lines += _section("SCEE_SCALE_FACTOR", "E", [1.2] * len(top.torsion_k))
    lines += _section("SCNB_SCALE_FACTOR", "E", [2.0] * len(top.torsion_k))
    lines += _section("LENNARD_JONES_ACOEF", "E", acoef)
    lines += _section("LENNARD_JONES_BCOEF", "E", bcoef)
    lines += _section("BONDS_INC_HYDROGEN", "I", [])
    lines += _section("BONDS_WITHOUT_HYDROGEN", "I",
                      [v for b, (i, j) in enumerate(top.bond_idx)
                       for v in (3 * i, 3 * j, b + 1)])
    lines += _section("ANGLES_INC_HYDROGEN", "I", [])
    lines += _section("ANGLES_WITHOUT_HYDROGEN", "I",
                      [v for a, (i, j, k) in enumerate(top.angle_idx)
                       for v in (3 * i, 3 * j, 3 * k, a + 1)])
    lines += _section("DIHEDRALS_INC_HYDROGEN", "I", [])
    lines += _section("DIHEDRALS_WITHOUT_HYDROGEN", "I", dih)
    lines += _section("EXCLUDED_ATOMS_LIST", "I", excl)
    path.write_text("\n".join(lines) + "\n")


def write_inpcrd(path, x_nm):
    vals = [f"{v:12.7f}" for v in (x_nm / 0.1).reshape(-1)]
    body = ["".join(vals[i:i + 6]) for i in range(0, len(vals), 6)]
    path.write_text("\n".join(["LIG", f"{len(x_nm):6d}"] + body) + "\n")


def test_load_prmtop_inpcrd_match_jax(ligand, tmp_path):
    lig, x = ligand
    assert len(lig.bond_idx) and len(lig.angle_idx)
    write_prmtop(tmp_path / "lig.prmtop", lig)
    write_inpcrd(tmp_path / "lig.inpcrd", x)
    got = amber.load_prmtop(str(tmp_path / "lig.prmtop"))
    ref = jamber.load_prmtop(str(tmp_path / "lig.prmtop"))
    for f in ("natom", "masses", "charges", "sigmas", "epsilons",
              "atom_names", "residue_labels", "residue_pointers", "bond_idx",
              "bond_k", "bond_r0", "angle_idx", "angle_k", "angle_t0",
              "torsion_idx", "torsion_k", "torsion_per", "torsion_phase",
              "exclusions", "pairs14", "scee", "scnb"):
        a, b = getattr(got, f), getattr(ref, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f
    np.testing.assert_array_equal(
        amber.load_inpcrd(str(tmp_path / "lig.inpcrd")),
        jamber.load_inpcrd(str(tmp_path / "lig.inpcrd")))
    # and the round trip reproduces the topology it was written from
    np.testing.assert_allclose(got.bond_r0, lig.bond_r0, rtol=1e-7)
    np.testing.assert_allclose(got.sigmas, lig.sigmas, rtol=1e-7)
    np.testing.assert_allclose(got.charges, lig.charges, atol=1e-8)
    assert got.exclusions == sorted(lig.exclusions)
    np.testing.assert_array_equal(got.pairs14, lig.pairs14)


def _systems(lig, hydrogen_mass=4.0):
    return (jsystem.system_from_amber(lig, dtype=jnp.float64,
                                      hydrogen_mass=hydrogen_mass),
            system.system_from_amber(lig, dtype=torch.float64,
                                     hydrogen_mass=hydrogen_mass,
                                     device="cpu"))


def test_system_from_amber_matches_jax(ligand):
    lig, _ = ligand
    js, ts = _systems(lig)
    for f in convert.SYSTEM_FIELDS:
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-12)
    for f in convert.PAIR_FIELDS:
        np.testing.assert_allclose(getattr(ts.pairs, f).numpy(),
                                   np.asarray(getattr(js.pairs, f)),
                                   rtol=1e-12)
    assert float(ts.masses.sum()) == pytest.approx(lig.masses.sum())
    # constraints are opt-in; tests/test_torch_constraints.py holds them
    # against the JAX package
    assert ts.constraints is None
    cs = system.system_from_amber(lig, constraints="h_bonds",
                                  device="cpu").constraints
    has_h = (lig.masses < 2.0)[lig.bond_idx].any(1)
    assert cs.num_constraints == int(has_h.sum()) > 0


def _perturbed(x, seed, lead=(3,)):
    rng = np.random.default_rng(seed)
    return x + 0.01 * rng.standard_normal(lead + x.shape)


def test_bonded_and_pair_forces_match_jax(ligand):
    lig, x = ligand
    js, ts = _systems(lig)
    xs = _perturbed(x, 1)
    e, f = forcefield.bonded_energy_forces(torch.from_numpy(xs), ts)
    ep, fp = pairwise.pair_energy_forces(ts.pairs, torch.from_numpy(xs))
    for r in range(xs.shape[0]):
        je, jf = jff.bonded_energy_forces(jnp.asarray(xs[r]), js)
        jep, jfp = jpairwise.pair_energy_forces(js.pairs, jnp.asarray(xs[r]))
        np.testing.assert_allclose(float(e[r]), float(je), rtol=1e-10)
        np.testing.assert_allclose(f[r].numpy(), np.asarray(jf), rtol=1e-10,
                                   atol=1e-9)
        np.testing.assert_allclose(float(ep[r]), float(jep), rtol=1e-10)
        np.testing.assert_allclose(fp[r].numpy(), np.asarray(jfp),
                                   rtol=1e-10, atol=1e-9)


@pytest.mark.parametrize("term", ["bond", "angle", "torsion", "pair"])
def test_forces_match_autograd(ligand, term):
    """The port's closed-form forces vs torch.autograd of its energies
    (the counterpart of tests/test_forcefield_forces.py)."""
    lig, x = ligand
    _, ts = _systems(lig)
    xs = torch.from_numpy(_perturbed(x, 2, lead=(2,))).requires_grad_(True)
    if term == "pair":
        e_fn = lambda p: pairwise.pair_energy(ts.pairs, p)  # noqa: E731
        f = pairwise.pair_energy_forces(ts.pairs, xs.detach())[1]
    else:
        args = {"bond": (ts.bond_idx, ts.bond_k, ts.bond_r0),
                "angle": (ts.angle_idx, ts.angle_k, ts.angle_t0),
                "torsion": (ts.torsion_idx, ts.torsion_k, ts.torsion_per,
                            ts.torsion_phase)}[term]
        e_fn = lambda p: getattr(forcefield, f"{term}_energy")(  # noqa
            p, *args)
        ef = getattr(forcefield, f"{term}_energy_forces")(xs.detach(), *args)
        np.testing.assert_allclose(ef[0].numpy(),
                                   e_fn(xs.detach()).numpy(), rtol=1e-12)
        f = ef[1]
    (g,) = torch.autograd.grad(e_fn(xs).sum(), xs)
    np.testing.assert_allclose(f.numpy(), -g.numpy(), rtol=1e-9, atol=1e-9)


def test_energy_and_forces_match_jax(ligand):
    """Bonded + pairs + one fused B-spline grid set (atoms partly outside
    the box)."""
    lig, x = ligand
    js, ts = _systems(lig)
    rng = np.random.default_rng(3)
    lo = x.min(0) - 0.2
    counts = tuple(int(c) + 1 for c in np.ceil((x.max(0) + 0.1 - lo) / 0.1))
    jpacks, tpacks = [], []
    for g in range(3):
        vals = rng.standard_normal(counts) * 30.0
        jg = JGrid.create(vals, (0.1,) * 3, lo, interp_method=1,
                          dtype=jnp.float64)
        jpacks.append(jpacked.pack_grid(jg))
        tpacks.append(packed.pack_grid(convert.grid_from_arrays(
            vals, (0.1,) * 3, lo, interp_method=1, device="cpu")))
    scal = rng.uniform(-1, 1, (3, lig.natom))
    jb = jsystem.GridBinding(grid=jpacked.combine_packed_grids(jpacks),
                             scaling=jnp.asarray(scal))
    tb = system.GridBinding(grid=packed.combine_packed_grids(tpacks),
                            scaling=torch.from_numpy(scal))
    xs = _perturbed(x, 4)
    e, f = system.energy_and_forces(ts, [tb], torch.from_numpy(xs))
    pe = system.potential_energy(ts, [tb], torch.from_numpy(xs))
    np.testing.assert_allclose(pe.numpy(), e.numpy(), rtol=1e-12)
    for r in range(xs.shape[0]):
        je, jf = jsystem.energy_and_forces(js, [jb], jnp.asarray(xs[r]))
        np.testing.assert_allclose(float(e[r]), float(je), rtol=1e-10)
        np.testing.assert_allclose(f[r].numpy(), np.asarray(jf), rtol=1e-10,
                                   atol=1e-8)
        jg = jsystem.grid_energy([jb], jnp.asarray(xs[r]))
        tg = system.grid_energy([tb], torch.from_numpy(xs[r]))
        np.testing.assert_allclose(float(tg), float(jg), rtol=1e-10)
    assert jax.config.jax_enable_x64
