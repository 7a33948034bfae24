"""The host side of the constraint kernel (``ops/cuda_constraints.py``):
its tables, launch plan and limits, its build flags and the host route of
``apply_shake`` / ``apply_rattle``, on the benchmark's ligand
(``gfbench/complex.py``, structure seed 0) with HBonds constraints. The
kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from gfbench import complex as bench_complex
from gfbench import program
from openmmgridforce_tpu_torch import cuda_build
from openmmgridforce_tpu_torch.mm import constraints, system_from_amber
from openmmgridforce_tpu_torch.ops import cuda_constraints as cc
from openmmgridforce_tpu_torch.ops.scatter import fixed_order_plan


@pytest.fixture(scope="module")
def ligand():
    lig, _ = bench_complex.synthetic_complex(5, 47, 50, 1.3, 0.1,
                                             structure_seed=0)
    return lig


def _constraints(ligand, dtype=torch.float64):
    return system_from_amber(program.topology(ligand), dtype=dtype,
                             hydrogen_mass=4.0, constraints="HBonds",
                             device="cpu").constraints


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tables_hold_the_twins_rows_in_its_order(ligand, dtype):
    """Each atom's rows, constraints and weights are the twin's fixed-order
    row sum's (``ops/scatter.py``, padding left out), and the pairs' scalars
    are the twin's, bit for bit."""
    cs = _constraints(ligand, dtype)
    n_pairs, n_atoms = cs.num_constraints, cs.inv_mass.shape[0]
    assert (n_pairs, n_atoms) == (27, 47)
    t = cc.constraint_tables(cs)
    assert cc.constraint_tables(cs) is t          # cached by the set
    b = constraints._pair_tensors(cs)
    plan = fixed_order_plan(b["idx"], n_atoms, (cs.idx,),
                            coef=torch.cat([-b["im_i"], b["im_j"]])[:, 0],
                            src_rows=n_pairs)
    depth = plan.weight.shape[1]
    sel = plan.sel.reshape(n_atoms, depth).numpy()
    weight = plan.weight[..., 0].numpy()
    start = t.row_start.numpy()
    assert start[0] == 0 and start[-1] == 2 * n_pairs
    for atom in range(n_atoms):
        lo, hi = start[atom], start[atom + 1]
        np.testing.assert_array_equal(t.row_pair[lo:hi].numpy(),
                                      sel[atom, :hi - lo])
        assert torch.equal(t.row_weight[lo:hi],
                           torch.as_tensor(weight[atom, :hi - lo]))
        assert not weight[atom, hi - lo:].any()     # the padding's zeros
    assert torch.equal(t.pairs.long(), cs.idx)
    assert torch.equal(t.length_sq, cs.length * cs.length)
    assert torch.equal(t.two_im, 2.0 * (b["im_i"] + b["im_j"])[:, 0])
    assert torch.equal(t.im_sum, (b["im_i"] + b["im_j"])[:, 0])
    assert t.pairs.dtype == t.row_start.dtype == t.row_pair.dtype \
        == torch.int32
    assert t.row_weight.dtype == t.length_sq.dtype == dtype


def test_launch_plan_and_its_limit():
    """A warp or more a block, one thread an atom or constraint up to 256;
    the replica and the set's tables staged in shared memory, and a set
    too large for a block refused."""
    assert cc.launch_plan(47, 27, torch.float32) == (
        64, (3 * 47 + 270) * 4 + (4 * 27 + 48) * 4)
    assert cc.launch_plan(47, 27, torch.float64) == (
        64, (3 * 47 + 270) * 8 + (4 * 27 + 48) * 4)
    assert cc.launch_plan(5, 2, torch.float32)[0] == 32
    assert cc.launch_plan(2000, 1900, torch.float32)[0] == 256
    with pytest.raises(ValueError, match="shared memory"):
        cc.launch_plan(6000, 6000, torch.float64)


def test_the_wrappers_refuse_what_the_kernel_does_not_take(ligand):
    cs = _constraints(ligand)
    x = torch.zeros(2, 47, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="no constraint kernel for device"):
        cc.constraint_shake(cs, x, x, 2e-5, 150, 1.0)
    with pytest.raises(ValueError, match="float32 or float64"):
        cc.constraint_rattle(cs, x.half(), x.half(), 1e-8, 100, 1.0)
    assert cc.constraint_shake.launches == cc.constraint_rattle.launches == 0


def test_the_kernel_is_built_without_contraction():
    """The kernel repeats its twin's arithmetic: its library is compiled
    with ``-fmad=false`` and precise division, the others with the shared
    flags alone, and its source fuses no product by hand."""
    flags = " ".join(cuda_build.flags("constraints"))
    assert "-fmad=false" in flags
    for flag in ("use_fast_math", "ftz=true", "prec-div=false"):
        assert flag not in flags
    assert cuda_build.flags("ligand_forces") == cuda_build.NVCC_FLAGS
    assert cuda_build.library_path("constraints") \
        != cuda_build.library_path("ligand_forces")
    source = (cuda_build.CSRC / "constraints.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in source.splitlines())
    for fused in ("fma(", "fmaf(", "__fma", "__fdividef", "__ddiv"):
        assert fused not in code


@pytest.mark.parametrize("kind", ["shake", "rattle"])
def test_the_host_route_is_the_twin(ligand, kind):
    """On the host ``apply_shake`` / ``apply_rattle`` are the plain twin,
    counted in the function's stats, and launch no kernel."""
    cs = _constraints(ligand)
    rng = np.random.default_rng(7)
    lig_x = torch.as_tensor(ligand.coords)
    x_ref = lig_x + 0.003 * torch.as_tensor(rng.standard_normal((4, 47, 3)))
    other = x_ref + 0.004 * torch.as_tensor(rng.standard_normal(x_ref.shape))
    fn = getattr(constraints, f"apply_{kind}")
    plain = getattr(constraints, f"{kind}_plain")
    fn.stats.reset()
    got = fn(cs, x_ref, other)
    want = plain(cs, x_ref, other)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fn.stats.summary()["calls"] == 1
    assert cc.constraint_shake.launches == cc.constraint_rattle.launches == 0
    fn.stats.reset()
