"""The port's package boundary: no JAX inside, no silent fall back to the
host, and the kernel wrapper's CPU route."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import openmmgridforce_tpu_torch as port
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.mm import system
from openmmgridforce_tpu_torch.ops import cuda_gridgen, gridgen, pairwise
from openmmgridforce_tpu_torch.parallel import replicas

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "openmmgridforce_tpu_torch"


def _module_names():
    return sorted(
        "openmmgridforce_tpu_torch"
        + "".join("." + p for p in f.relative_to(PKG).with_suffix("").parts)
        .replace(".__init__", "")
        for f in PKG.rglob("*.py"))


def test_port_imports_no_jax():
    mods = _module_names()
    assert "openmmgridforce_tpu_torch.ops.cuda_gridgen" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
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
    for f in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not banned.search(f.read_text()), f


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no device given and no CUDA card, nothing quietly runs on the
    host."""
    from chip_smoke import synthetic_complex

    _no_cuda(monkeypatch)
    lig, x, _, _ = synthetic_complex(3, n_ligand=8, n_receptor=5)
    z = np.zeros((3, 3, 3))
    calls = [
        lambda: port.resolve_device(),
        lambda: gridgen.generate_grid((3, 3, 3), (0.1,) * 3, (0.0,) * 3,
                                      "charge", x, lig.charges, lig.sigmas,
                                      lig.epsilons),
        lambda: system.system_from_amber(lig),
        lambda: pairwise.build_pair_table(lig.charges, lig.sigmas,
                                          lig.epsilons),
        lambda: replicas.init_replica_states(torch.Generator(), x,
                                             lig.masses, 300.0, 2),
        lambda: system.make_md_runner(2, 0.001, 1.0),
        lambda: convert.grid_from_arrays(z, (0.1,) * 3, (0.0,) * 3),
        lambda: convert.states_from_arrays(x, x, seed=0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


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
