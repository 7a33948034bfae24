"""Checks of the port that need an NVIDIA GPU (marker ``cuda``; skipped
without one). This file imports no JAX, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from openmmgridforce_tpu_torch.ops import cuda_gridgen, gridgen

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("grid_type", ["charge", "ljr", "lja"])
def test_kernel_matches_plain_twin(cuda, grid_type):
    rng = np.random.default_rng(53)
    n = 301                                   # not a multiple of the tile
    atoms = gridgen.receptor_atoms(
        grid_type, rng.uniform(-0.3, 1.2, (n, 3)), rng.uniform(-1, 1, n),
        rng.uniform(0.2, 0.35, n), rng.uniform(0.1, 1.0, n), device=cuda)
    args = ((19, 21, 23), (0.1, 0.11, 0.09), (0.0, -0.2, 0.3), grid_type,
            800.0)
    before = cuda_gridgen.gridgen_values.launches
    got = cuda_gridgen.gridgen_values(atoms, *args)
    ref = cuda_gridgen.gridgen_values_plain(atoms, *args)
    torch.cuda.synchronize()
    assert cuda_gridgen.gridgen_values.launches == before + 1
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_cap_on_atom_and_dtype_rules(cuda):
    on_atom = torch.tensor([[0.1, 0.1, 0.1, 1.0]], device=cuda)
    got = cuda_gridgen.gridgen_values(on_atom, (3, 3, 3), (0.1,) * 3,
                                      (0.0,) * 3, "ljr", 500.0)
    assert float(got[1, 1, 1]) == 500.0
    with pytest.raises(NotImplementedError, match="float64"):
        cuda_gridgen.gridgen_values(on_atom.double(), (3, 3, 3), (0.1,) * 3,
                                    (0.0,) * 3, "ljr", 500.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gridgen.generate_grid((3, 3, 3), (0.1,) * 3, (0.0,) * 3, "ljr",
                              np.array([[0.1] * 3]), [0.0], [0.3], [1.0],
                              dtype=torch.float64, device=cuda)
