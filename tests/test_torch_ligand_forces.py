"""The host side of the intra-ligand force kernels
(``ops/cuda_ligand_forces.py``): their per-atom tables, launch plans and
limits, and the host route of ``energy_and_forces``, on the benchmark's
ligand (``gfbench/complex.py``, structure seed 0), an HBonds-constrained
copy and a copy without pairs. The kernels themselves run only on the
card (``tests/test_torch_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from gfbench import complex as bench_complex
from gfbench import program
from openmmgridforce_tpu_torch import cuda_build
from openmmgridforce_tpu_torch.mm import energy_and_forces, system_from_amber
from openmmgridforce_tpu_torch.mm.forcefield import (bonded_energy_forces,
                                                     bonded_rows)
from openmmgridforce_tpu_torch.ops import cuda_ligand_forces as lf
from openmmgridforce_tpu_torch.ops import scatter
from openmmgridforce_tpu_torch.ops.pairwise import pair_energy_forces
from openmmgridforce_tpu_torch.ops.scatter import row_table

VARIANTS = {"bench": {}, "hbonds": {"constraints": "HBonds"},
            "no_pairs": {"include_nonbonded": False}}


@pytest.fixture(scope="module")
def ligand():
    lig, _ = bench_complex.synthetic_complex(5, 47, 50, 1.3, 0.1,
                                             structure_seed=0)
    return lig


def _system(ligand, variant, dtype=torch.float64):
    return system_from_amber(program.topology(ligand), dtype=dtype,
                             hydrogen_mass=4.0, device="cpu",
                             **VARIANTS[variant])


def _partners(table):
    """{atom: (its partners, their (qq, sigma, epsilon))}."""
    p = lf.pair_partners(table)
    start, entries = p.start.numpy(), p.entries.numpy()
    return {i: (entries[start[i]:start[i + 1], 3].astype(int),
                entries[start[i]:start[i + 1], :3])
            for i in range(len(start) - 1)}


def test_the_bench_ligand_and_its_launch_plans(ligand):
    system = _system(ligand, "bench", torch.float32)
    assert (len(system.bond_idx), len(system.angle_idx),
            len(system.torsion_idx)) == (46, 80, 113)
    assert len(bonded_rows(system)) == 784
    assert int(system.pairs.mask.sum()) == 955
    # a replica a block at 128 threads for the 239 terms, the rows' table
    # staged once; 5 replicas of 47 atoms a block for the pairs, a warp for
    # each replica's energy, with the 1,910 partner entries staged
    rows = (48 + 784) * 4
    assert lf.bonded_plan(system, 47, torch.float32) == lf.LaunchPlan(
        1, 128, (3 * 47 + 3 * 784 + 239) * 4 + rows, rows)
    table = 1910 * 16 + 48 * 4
    assert len(lf.pair_partners(system.pairs).entries) == 1910
    assert lf.pair_plan(47, 1910, torch.float32) == lf.LaunchPlan(
        5, 256, 5 * 4 * 47 * 4 + table, table)
    assert lf.pair_plan(47, 1910, torch.float64).shared_bytes == \
        5 * 4 * 47 * 8 + 1910 * 32 + 48 * 4
    assert lf.pair_plan(1, 0, torch.float32) == lf.LaunchPlan(
        8, 256, 8 * 16 + 8, 8)
    assert lf.pair_plan(300, 0, torch.float32).replicas == 1
    # a partner table that does not fit beside a replica is read from
    # device memory
    assert lf.pair_plan(47, 20000, torch.float32).table_bytes == 0
    assert lf.launch_plan(40, 100, 0, 256, "k").threads == 256
    assert lf.launch_plan(40, 100, 0, 128, "k") == lf.LaunchPlan(
        3, 128, 300, 0)
    # small replicas: as many a block as have a warp each
    assert lf.launch_plan(5, 100, 0, 128, "k") == lf.LaunchPlan(
        4, 128, 400, 0)


@pytest.mark.parametrize("variant", ["bench", "hbonds"])
def test_every_live_pair_is_a_partner_of_both_atoms_once(ligand, variant):
    table = _system(ligand, variant).pairs
    lists = _partners(table)
    mask = table.mask.numpy()
    live = {(int(i), int(j)) for i, j in zip(*np.nonzero(mask))}
    assert sum(len(p) for p, _ in lists.values()) == 2 * len(live)
    for i, (partner, params) in lists.items():
        assert list(partner) == sorted(set(partner.tolist()))
        for j, prm in zip(partner, params):
            a, b = min(i, j), max(i, j)
            assert (a, b) in live
            np.testing.assert_array_equal(
                prm, [table.qq[a, b], table.sigma[a, b],
                      table.epsilon[a, b]])
    for a, b in live:
        assert list(lists[a][0]).count(b) == 1
        assert list(lists[b][0]).count(a) == 1


def test_an_excluded_14_exception_is_a_partner(ligand):
    table = _system(ligand, "bench").pairs
    lists = _partners(table)
    excluded = {tuple(sorted(p)) for p in ligand.exclusions}
    pairs14 = [tuple(sorted(p)) for p in ligand.pairs14.tolist()]
    both = [p for p in pairs14 if p in excluded]
    assert both
    for n, (a, b) in enumerate(pairs14):
        if (a, b) not in excluded:
            continue
        k = list(lists[a][0]).index(b)
        qq = ligand.charges[a] * ligand.charges[b] / ligand.scee[n]
        assert lists[a][1][k][0] == pytest.approx(qq, rel=1e-15)
        assert a in lists[b][0]


def test_a_masked_pair_is_absent(ligand):
    lists = _partners(_system(ligand, "bench").pairs)
    i, j = (int(v) for v in ligand.bond_idx[0])
    assert j not in lists[i][0] and i not in lists[j][0]
    assert i not in lists[i][0]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_each_atom_receives_its_terms_rows_in_row_table_order(ligand,
                                                              variant):
    system = _system(ligand, variant)
    n = system.num_atoms
    table = lf.bonded_table(system, n)
    start, rows = table.row_start.numpy(), table.rows.numpy()
    want = row_table(bonded_rows(system), n)
    k = len(bonded_rows(system))
    for atom in range(n):
        got = rows[start[atom]:start[atom + 1]]
        np.testing.assert_array_equal(got, want[atom][want[atom] < k])
    # the rows of each term, at their places in the twin's concatenation
    b, a, t = (len(system.bond_idx), len(system.angle_idx),
               len(system.torsion_idx))
    expect = {atom: [] for atom in range(n)}
    for c in range(2):
        for q in range(b):
            expect[int(system.bond_idx[q, c])].append(c * b + q)
    for s, c in enumerate((0, 2, 1)):
        for q in range(a):
            expect[int(system.angle_idx[q, c])].append(2 * b + s * a + q)
    for c in range(4):
        for q in range(t):
            expect[int(system.torsion_idx[q, c])].append(
                2 * b + 3 * a + c * t + q)
    for atom in range(n):
        assert sorted(rows[start[atom]:start[atom + 1]].tolist()) == \
            sorted(expect[atom])
    if variant == "hbonds":
        assert b < len(ligand.bond_idx)
    if variant == "bench":
        assert max(np.diff(start)) == 48


def test_the_tables_are_built_once_per_system(ligand):
    system = _system(ligand, "bench")
    first = (lf.bonded_table(system, 47), lf.pair_partners(system.pairs))
    assert lf.bonded_table(system, 47) is first[0]
    assert lf.pair_partners(system.pairs) is first[1]
    other = _system(ligand, "bench")
    assert lf.bonded_table(other, 47) is not first[0]
    ids = id(other.bond_idx)
    del other
    lf.bonded_table(system, 48)   # a new entry drops the dead ones
    assert not any(key[0][0] == ids for key in scatter._TABLES)


@pytest.mark.parametrize("variant", ["bench", "hbonds", "no_pairs"])
def test_energy_and_forces_on_the_host_takes_the_twins(ligand, variant):
    system = _system(ligand, variant)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(ligand.coords + 0.01 * rng.standard_normal(
        (3, 47, 3)))
    launches = (lf.ligand_bonded.launches, lf.ligand_pairs.launches)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        energy, forces = energy_and_forces(system, [], x)
    e_want, f_want = bonded_energy_forces(x, system)
    spans = {"omgf.force.bonded"}
    if system.pairs is not None:
        e_p, f_p = pair_energy_forces(system.pairs, x)
        e_want, f_want = e_want + e_p, f_want + f_p
        spans.add("omgf.force.pair")
    assert torch.equal(energy, e_want) and torch.equal(forces, f_want)
    assert spans <= {e.name for e in prof.events()}
    assert (lf.ligand_bonded.launches, lf.ligand_pairs.launches) == launches
    # an unbatched [N, 3] takes the same route
    e1, f1 = energy_and_forces(system, [], x[1])
    torch.testing.assert_close(e1, energy[1], rtol=1e-13, atol=0)
    torch.testing.assert_close(f1, forces[1], rtol=1e-13, atol=1e-13)


def test_a_shape_over_the_limit_raises(ligand):
    system = _system(ligand, "bench")
    with pytest.raises(ValueError, match="232448"):
        lf.bonded_plan(system, 20000, torch.float64)
    with pytest.raises(ValueError, match="232448"):
        lf.pair_plan(8000, 0, torch.float64)
    assert lf.pair_plan(7000, 10 ** 6, torch.float64).replicas == 1


def test_what_the_kernels_do_not_take_raises(ligand):
    table = _system(ligand, "bench").pairs
    for mask in (table.mask.T, 0.5 * table.mask):
        bad = dataclasses.replace(table, mask=mask.contiguous())
        with pytest.raises(ValueError, match="mask"):
            lf.pair_partners(bad)
    system = _system(ligand, "bench")
    bad = dataclasses.replace(system, bond_idx=system.bond_idx + 47)
    with pytest.raises(ValueError, match="outside"):
        lf.bonded_table(bad, 47)
    bad = dataclasses.replace(system, bond_k=system.bond_k[:-1])
    with pytest.raises(ValueError, match="bond parameters"):
        lf.bonded_table(bad, 47)
    x = torch.zeros(2, 47, 3, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or float64"):
        lf._check_cuda("ligand_bonded", x, {})
    with pytest.raises(ValueError, match="no ligand_bonded kernel"):
        lf._check_cuda("ligand_bonded", x.double(), {})


def test_the_kernels_are_built_with_precise_maths():
    """No fast-math flag in the build and no fast intrinsic in the source:
    the float32 gates on the card scale with the float32 twin's error, so
    they alone would not catch an approximate sin, cos, atan2 or acos
    (chip_smoke.py's sass phase also finds no MUFU.SIN or MUFU.COS in the
    library)."""
    flags = " ".join(cuda_build.NVCC_FLAGS)
    for flag in ("use_fast_math", "ftz=true", "prec-div=false",
                 "prec-sqrt=false"):
        assert flag not in flags
    source = (cuda_build.CSRC / "ligand_forces.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in source.splitlines())
    for fast in ("__sinf", "__cosf", "__sincosf", "__tanf", "__expf",
                 "__logf", "__powf", "__fdividef", "__frsqrt_rn"):
        assert fast not in code
    for precise in ("acosf(", "atan2f(", "sinf(", "cosf("):
        assert precise in code
