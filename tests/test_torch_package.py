"""The port's package boundary: no JAX inside, no silent fall back to the
host, and the kernel wrapper's CPU route."""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import openmmgridforce_tpu_torch as port
import openmmgridforce_tpu_torch.api as api
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.mm import constraints, system
from openmmgridforce_tpu_torch import cuda_build
from openmmgridforce_tpu_torch.io import streaming
from openmmgridforce_tpu_torch.ops import (cuda_gridgen, cuda_gridgen_derivs,
                                           gridgen, packed, pairwise, radial)
from openmmgridforce_tpu_torch.parallel import replicas
from openmmgridforce_tpu_torch.sampling import Sampler, SamplerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "openmmgridforce_tpu_torch"
EXAMPLE = ROOT / "examples" / "bpmf_sampler_torch.py"
DOCKING = ROOT / "examples" / "docking_screen_torch.py"


def _module_names():
    return sorted(
        "openmmgridforce_tpu_torch"
        + "".join("." + p for p in f.relative_to(PKG).with_suffix("").parts)
        .replace(".__init__", "")
        for f in PKG.rglob("*.py"))


def test_port_imports_no_jax():
    mods = _module_names()
    for new in ("ops.cuda_gridgen", "ops.cuda_gridgen_derivs",
                "ops.derivatives27", "ops.interpolate", "mm.constraints",
                "sampling", "sampling.bat", "sampling.sampler", "utils",
                "utils.checkpoint", "utils.observe", "io", "io.omgtile",
                "io.native", "io.v3", "io.gridio", "io.streaming",
                "ops.fd_derivs", "mm.streamed_md", "api", "api.context",
                "api.gridforce", "api.isolated", "api.lbfgs"):
        assert "openmmgridforce_tpu_torch." + new in mods
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            f"for path in {[str(EXAMPLE), str(DOCKING)]!r}:\n"
            "    spec = importlib.util.spec_from_file_location('ex', path)\n"
            "    spec.loader.exec_module("
            "importlib.util.module_from_spec(spec))\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'openmmgridforce_tpu' or "
            "m.startswith('openmmgridforce_tpu.')]\n"
            "print(len(bad), bad[:5])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout


def test_no_jax_in_sources():
    banned = re.compile(
        r"^\s*(from|import)\s+(jax|openmmgridforce_tpu)(\.|\s|$)", re.M)
    for f in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py", EXAMPLE, DOCKING]:
        assert not banned.search(f.read_text()), f


def test_every_kernel_has_its_source():
    """One library per kernel of the TPU-kernel table, each with its
    sources under csrc/, a wrapper with a launch counter, and a plain twin
    beside it; beside them the binding that adds conditional WHILE nodes
    to recorded MD segments (no TPU kernel's port)."""
    kernels = {"gridgen_values", "gridgen_derivs"}
    assert set(cuda_build.LIBRARIES) == kernels | {"graph_while"}
    text = (cuda_build.CSRC / "graph_while.cu").read_text()
    assert 'extern "C"' in text and "__global__" in text
    assert "cudaGraphCondTypeWhile" in text
    for name in kernels:
        sources = cuda_build.LIBRARIES[name]
        assert sources, name
        for src in sources:
            text = (cuda_build.CSRC / src).read_text()
            assert f'extern "C" int {name}_launch(' in text, src
            assert "__global__" in text, src
    for module, name in ((cuda_gridgen, "gridgen_values"),
                         (cuda_gridgen_derivs, "gridgen_derivs")):
        assert getattr(module, name).launches == 0
        assert callable(getattr(module, name + "_plain"))


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no device given and no CUDA card, nothing quietly runs on the
    host."""
    from chip_smoke import synthetic_complex

    _no_cuda(monkeypatch)
    lig, x, _, _ = synthetic_complex(3, n_ligand=8, n_receptor=5)
    z = np.zeros((3, 3, 3))
    grid = convert.grid_from_arrays(z, (0.1,) * 3, (0.0,) * 3, device="cpu",
                                    interp_method=1)
    cpu_system = system.system_from_amber(lig, constraints="HBonds",
                                          device="cpu")
    cpu_api_system = api.create_system(lig, device="cpu")
    calls = [
        lambda: port.resolve_device(),
        lambda: gridgen.generate_grid((3, 3, 3), (0.1,) * 3, (0.0,) * 3,
                                      "charge", x, lig.charges, lig.sigmas,
                                      lig.epsilons),
        lambda: gridgen.generate_grid((3, 3, 3), (0.1,) * 3, (0.0,) * 3,
                                      "charge", x, lig.charges, lig.sigmas,
                                      lig.epsilons,
                                      compute_derivatives=True),
        lambda: system.system_from_amber(lig),
        lambda: pairwise.build_pair_table(lig.charges, lig.sigmas,
                                          lig.epsilons),
        lambda: replicas.init_replica_states(torch.Generator(), x,
                                             lig.masses, 300.0, 2),
        lambda: system.make_md_runner(2, 0.001, 1.0),
        lambda: convert.grid_from_arrays(z, (0.1,) * 3, (0.0,) * 3),
        lambda: convert.states_from_arrays(x, x, seed=0),
        lambda: convert.hermite_packed_from_arrays(
            np.zeros((8, 64)), (0.1,) * 3, (0.0,) * 3, counts=(3, 3, 3),
            method=2),
        lambda: convert.constraints_from_arrays(np.zeros((1, 2)), [0.1],
                                                [1.0, 1.0]),
        lambda: system.make_md_runner(2, 0.001, 1.0, scheme="middle"),
        lambda: packed.pack_grids_fused([grid]),
        lambda: Sampler(cpu_system, [], x, SamplerConfig(n_states=2)),
        lambda: _example().main(["-i", "input.json", "--generate-grids"]),
        lambda: gridgen.generate_grid_to_tiled_file(
            "never-written.tiled", (3, 3, 3), (0.1,) * 3, (0.0,) * 3,
            "charge", x, lig.charges, lig.sigmas, lig.epsilons),
        lambda: port.grid.grid_from_numpy(z, (0.1,) * 3),
        lambda: streaming.StreamedGridEvaluator("never-read.tiled"),
        lambda: port.io.grid_from_file(str(ROOT / "never-read.grid")),
        lambda: constraints.constraints_from_bonds(lig.bond_idx, lig.bond_r0,
                                                   lig.masses),
        lambda: api.create_system(lig),
        lambda: api.Context(cpu_api_system, api.VerletIntegrator(0.001)),
        lambda: api.Simulation(lig, cpu_api_system,
                               api.VerletIntegrator(0.001)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _example():
    spec = importlib.util.spec_from_file_location("bpmf_sampler_torch",
                                                  EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_wrapper_takes_plain_twin_on_cpu():
    before = cuda_gridgen.gridgen_values.launches
    atoms = torch.tensor([[0.1, 0.2, 0.3, 2.0], [0.5, 0.1, 0.0, -1.0]],
                         dtype=torch.float64)
    args = ((4, 5, 6), (0.1, 0.1, 0.1), (0.0, 0.0, 0.0), "charge", 100.0)
    got = cuda_gridgen.gridgen_values(atoms, *args)
    ref = cuda_gridgen.gridgen_values_plain(atoms, *args)
    assert torch.equal(got, ref) and got.shape == (4, 5, 6)
    assert cuda_gridgen.gridgen_values.launches == before == 0
    with pytest.raises(ValueError, match=r"\[A, 4\]"):
        cuda_gridgen.gridgen_values(atoms[:, :3], *args)


def test_plain_twin_chunks_agree():
    """The chunked plain twin does not depend on its chunk size."""
    rng = np.random.default_rng(0)
    atoms = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 1, (13, 3)), rng.uniform(-5, 5, (13, 1))], 1))
    args = ((6, 7, 5), (0.2, 0.15, 0.25), (-0.1, 0.0, 0.1), "lja", 50.0)
    a = cuda_gridgen.gridgen_values_plain(atoms, *args)
    b = cuda_gridgen.gridgen_values_plain(atoms, *args, pair_block=29)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14)


def test_derivs_wrapper_takes_plain_twin_on_cpu():
    before = cuda_gridgen_derivs.gridgen_derivs.launches
    atoms = torch.tensor([[0.1, 0.2, 0.3, 2.0], [0.5, 0.1, 0.0, -1.0]],
                         dtype=torch.float64)
    args = ((4, 5, 6), (0.1, 0.1, 0.1), (0.0, 0.0, 0.0), "charge")
    got = cuda_gridgen_derivs.gridgen_derivs(atoms, *args)
    ref = cuda_gridgen_derivs.gridgen_derivs_plain(atoms, *args)
    assert got.shape == (4, 5, 6, 27)
    assert torch.equal(got.reshape(-1, 27), ref)
    assert cuda_gridgen_derivs.gridgen_derivs.launches == before == 0
    # slot 0 is the uncapped field itself: K / r with r >= 0.02 nm
    point = torch.tensor([0.3, 0.4, 0.5], dtype=torch.float64)
    r = (point - atoms[:, :3]).norm(dim=1)
    np.testing.assert_allclose(float(got[3, 4, 5, 0]),
                               float(2.0 / r[0] - 1.0 / r[1]), rtol=1e-12)


def _unfolded_pair_terms(dx, dy, dz, K, grid_type):
    """The oracle of the folded twin: the seven radial derivatives
    coef[n] K / r^(m+n), powers by repeated multiplication, fed to the
    general cascade ``radial.cartesian_terms`` as it is written."""
    m, coefs = radial.FIELD_POWERS[grid_type]
    r2 = (dx * dx + dy * dy + dz * dz).clamp_min(
        cuda_gridgen_derivs.R2_MIN_DERIVS)
    inv_r = torch.rsqrt(r2)
    inv_rm = inv_r
    for _ in range(m - 1):
        inv_rm = inv_rm * inv_r
    base = K * inv_rm
    i2 = inv_r * inv_r
    i3 = i2 * inv_r
    i4 = i2 * i2
    i5 = i4 * inv_r
    i6 = i4 * i2
    rad = (base, coefs[1] * base * inv_r, coefs[2] * base * i2,
           coefs[3] * base * i3, coefs[4] * base * i4, coefs[5] * base * i5,
           coefs[6] * base * i6)
    return radial.cartesian_terms(dx, dy, dz, inv_r, i2, i3, i4, i5, *rad)


def test_chip_smoke_operation_counts_match_the_twin():
    """chip_smoke's bound counts the FP32 operations per pair that the
    derivative kernel's function needs: those of the package's folded
    ``pair_derivative_terms``, traced with a counting stand-in for a
    tensor. The folded twin is held against the unfolded cascade, which is
    traced too and may only cost more."""
    import chip_smoke

    class Counted:
        ops = 0
        rsqrts = 0

        def _op(self, *_):
            Counted.ops += 1
            return Counted()

        __mul__ = __rmul__ = __add__ = __radd__ = _op
        __sub__ = __rsub__ = clamp_min = _op

        @classmethod
        def __torch_function__(cls, func, types, args=(), kwargs=None):
            assert func is torch.rsqrt
            Counted.rsqrts += 1
            return Counted()

    def traced(fn, grid_type):
        Counted.ops = Counted.rsqrts = 0
        terms = fn(Counted(), Counted(), Counted(), Counted(), grid_type)
        assert Counted.rsqrts == 1
        # plus the displacement's 3 subtractions and the 27 additions
        # into the running sums
        return Counted.ops + 3 + len(terms)

    rng = np.random.default_rng(0)
    # displacements on both sides of the clamp at r = 0.02 nm
    d = torch.from_numpy(rng.uniform(-1, 1, (3, 400))
                         * rng.choice([0.01, 0.1, 1.0], 400))
    clamped = (d * d).sum(0) < cuda_gridgen_derivs.R2_MIN_DERIVS
    assert 50 < int(clamped.sum()) < 350
    K = torch.from_numpy(rng.uniform(-3, 3, 400))
    for grid_type, want in chip_smoke.DERIVS_OPS_PER_PAIR.items():
        got = cuda_gridgen_derivs.pair_derivative_terms(*d, K, grid_type)
        ref = _unfolded_pair_terms(*d, K, grid_type)
        assert len(got) == len(ref) == 27
        for slot, (g, r) in enumerate(zip(got, ref)):
            # float64; the oracle's alternating cascade sums cancel a few
            # digits
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-9,
                                       atol=1e-12 * float(r.abs().max()),
                                       err_msg=f"{grid_type} slot {slot}")
        assert traced(cuda_gridgen_derivs.pair_derivative_terms,
                      grid_type) == want, grid_type
        assert traced(_unfolded_pair_terms, grid_type) >= want, grid_type
