"""Fused packs and the observers, held by the port against the JAX package.

The port's counterparts of ``tests/test_multigrid.py`` (a fused pack of
three grids evaluates as the sum of its singles, its restraint applied
once; packs of different geometry refuse to fuse) and of
``tests/test_utils.py``'s observers (``StateDataReporter``,
``write_xyz_frame``), each also against the JAX package's output on the
same inputs: float64 evaluations to 1e-12, the observers' text character
for character.
"""

import io

import numpy as np
import pytest
import torch

from openmmgridforce_tpu import Grid as JGrid
from openmmgridforce_tpu import InterpolationMethod as JMethod
from openmmgridforce_tpu import InvPowerMode as JInvPowerMode
from openmmgridforce_tpu.ops import packed as jpacked
from openmmgridforce_tpu.utils import StateDataReporter as JReporter
from openmmgridforce_tpu.utils import write_xyz_frame as jwrite_xyz_frame
from openmmgridforce_tpu_torch.grid import (InterpolationMethod, InvPowerMode,
                                            grid_from_numpy)
from openmmgridforce_tpu_torch.ops import packed
from openmmgridforce_tpu_torch.utils import StateDataReporter, write_xyz_frame

torch.set_num_threads(1)

RNG = np.random.default_rng(41)
COUNTS = (7, 6, 8)
SPACING = (0.1, 0.12, 0.11)
ORIGIN = (0.2, -0.1, 0.4)


def _grid(vals, **kw):
    return grid_from_numpy(vals, SPACING, ORIGIN,
                           interp_method=InterpolationMethod.BSPLINE,
                           dtype=torch.float64, device="cpu", **kw)


def test_multigrid_matches_sum_of_singles():
    packs, jpacks, scals = [], [], []
    for i in range(3):
        vals = np.abs(RNG.standard_normal(COUNTS)) + 0.3
        stored = i == 1
        packs.append(packed.pack_grid(_grid(
            vals, inv_power_mode=(InvPowerMode.STORED if stored
                                  else InvPowerMode.NONE),
            inv_power=2.0 if stored else 0.0, oob_k=444.0)))
        jpacks.append(jpacked.pack_grid(JGrid.create(
            vals, SPACING, ORIGIN, interp_method=JMethod.BSPLINE,
            inv_power_mode=(JInvPowerMode.STORED if stored
                            else JInvPowerMode.NONE),
            inv_power=2.0 if stored else 0.0, oob_k=444.0,
            dtype=np.float64)))
        scals.append(RNG.standard_normal(40))

    lo = np.asarray(ORIGIN) - 0.05
    hi = (np.asarray(ORIGIN)
          + (np.asarray(COUNTS) - 1) * np.asarray(SPACING) + 0.05)
    pos = RNG.uniform(lo, hi, size=(40, 3))
    x = torch.as_tensor(pos)

    res = packed.evaluate_multi(packed.combine_packed_grids(packs), x,
                                torch.as_tensor(np.stack(scals)))
    jres = jpacked.evaluate_multi(jpacked.combine_packed_grids(jpacks), pos,
                                  np.stack(scals))
    got_pa = res.per_atom_energy.numpy()
    got_f = res.forces.numpy()
    np.testing.assert_allclose(got_pa, np.asarray(jres.per_atom_energy),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_f, np.asarray(jres.forces), rtol=1e-12,
                               atol=1e-12)

    # per-grid evaluation triple-counts the OOB restraint; the fused path
    # applies it once: inside atoms exactly, restraint-only atoms at 1x
    singles = [packed.evaluate_packed(p, x, torch.as_tensor(s))
               for p, s in zip(packs, scals)]
    want_pa = sum(s.per_atom_energy for s in singles).numpy()
    want_f = sum(s.forces for s in singles).numpy()
    inside = np.all((pos >= np.asarray(ORIGIN)) & (pos <= hi - 0.05), axis=1)
    assert 0 < inside.sum() < len(pos)
    np.testing.assert_allclose(got_pa[inside], want_pa[inside], rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(got_f[inside], want_f[inside], rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(got_pa[~inside] * 3.0, want_pa[~inside],
                               rtol=1e-9)


def test_combine_requires_matching_geometry():
    g1 = _grid(RNG.standard_normal(COUNTS))
    g2 = _grid(RNG.standard_normal((5, 5, 5)))
    with pytest.raises(ValueError, match="share"):
        packed.combine_packed_grids([packed.pack_grid(g1),
                                     packed.pack_grid(g2)])


def test_state_data_reporter_matches_jax():
    bufs = io.StringIO(), io.StringIO()
    for rep in (StateDataReporter(bufs[0], 10), JReporter(bufs[1], 10)):
        rep.report(10, -1234.5, 298.7)
        rep.report(20, -1230.1, 301.2)
    text = bufs[0].getvalue()
    assert text == bufs[1].getvalue()
    lines = text.strip().split("\n")
    assert lines[0].startswith('#"Step"')
    assert lines[1].split()[0] == "10"
    assert len(lines) == 3


def test_write_xyz_frame_matches_jax():
    pos = np.array([[0.1, 0.2, 0.3], [-0.45, 1.25, 0.0625]])
    bufs = io.StringIO(), io.StringIO()
    write_xyz_frame(bufs[0], "E=-1.0", torch.as_tensor(pos), ["O", "H"])
    jwrite_xyz_frame(bufs[1], "E=-1.0", pos, ["O", "H"])
    text = bufs[0].getvalue()
    assert text == bufs[1].getvalue()
    lines = text.strip().split("\n")
    assert lines[0] == "2"
    assert lines[2].startswith("O 1.0")
