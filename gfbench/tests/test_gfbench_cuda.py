"""On the card, at each cell's own size: the program's readings within
the cell's limits and the control's (the plain reference in TF32 in the
program's place) outside them. Skipped without a card."""

import json

import pytest
import torch

from gfbench import harness

CELLS = [w["name"] for w in json.loads(
    (harness.CHECKOUT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_where_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    files = harness.cell(name)
    s = files["kind"].Session(files["config"], files["mix"], 4000000007,
                              "cuda")
    s.setup()
    s.run_window(2.0)
    s.release()
    limits = files["cell"]["limits"]
    program, control = s.readings(), s.readings(control="tf32")
    assert s.window["failed"] == 0
    assert all(v <= limits[k] for k, v in program.items()), program
    assert any(v > limits[k] for k, v in control.items()), control
