"""Runs of the harness on the CPU at a tiny size with the timed path broken
underneath: each fault a cell can have makes ``correct`` false, and the
control (the reference in TF32 in the program's place) reads wider than
the program."""

import pytest

from gfbench import program
from gfbench.tests.tiny import tiny_files, tiny_run

MD = ["bspline-md-r1000", "triquintic-md-r1000"]
GEN = ["bspline-gen", "triquintic-gen"]


def _md_fault(monkeypatch, fault):
    real = program.md_runner

    def runner(n_steps, config, device):
        run = real(n_steps, config, device)

        def broken(states, system, grids, temps, noise=None):
            if fault == "unchanged":
                return states
            out = run(states, system, grids, temps, noise=noise)
            x, v = out.positions.clone(), out.velocities.clone()
            if fault == "half":
                half = x.shape[0] // 2
                x[half:], v[half:] = (states.positions[half:],
                                      states.velocities[half:])
            elif fault == "hot":           # one replica 100 x as hot
                v[0] *= 10.0
            else:                          # one atom's answer altered
                x[0, 0] += 1e-3
            return program.state(x, v)

        return broken

    monkeypatch.setattr(program, "md_runner", runner)


def _gen_fault(monkeypatch, fault):
    real_generate, real_pack = program.generate, program.pack

    def generate(config, box, coords, receptor, device):
        if fault == "unchanged":           # the first conformation's grids
            coords = receptor.coords
        elif fault == "half":              # half of the receptor's atoms
            coords = coords[::2]
            receptor = type(receptor)(
                elements=receptor.elements[::2],
                coords=receptor.coords[::2],
                charges=receptor.charges[::2],
                sigmas=receptor.sigmas[::2],
                epsilons=receptor.epsilons[::2])
        return real_generate(config, box, coords, receptor, device)

    def pack(grids):
        table = real_pack(grids)
        if fault == "altered":             # one grid's cells altered
            k = table.degree ** 3
            table.coeffs[:, :k] *= 1.0 + 1e-3
        return table

    monkeypatch.setattr(program, "generate", generate)
    monkeypatch.setattr(program, "pack", pack)


@pytest.mark.parametrize("name", MD + GEN)
def test_sound_runs_are_correct(name):
    result, checks = tiny_run(name)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", MD + GEN)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    (_md_fault if name in MD else _gen_fault)(monkeypatch, fault)
    result, checks = tiny_run(name)
    assert not result["correct"], checks


@pytest.mark.parametrize("name", MD)
def test_a_replica_past_the_temperature_limit_fails_its_segment(
        monkeypatch, name):
    _md_fault(monkeypatch, "hot")
    result, checks = tiny_run(name)
    assert result["failed"] == result["attempted"] >= 1
    assert not result["correct"], checks


@pytest.mark.parametrize("name", MD + GEN)
def test_the_control_reads_wider_than_the_program(name):
    """At the tiny size; tests/test_gfbench_cuda.py holds the control to
    the limits at the cells' own sizes on the card."""
    files = tiny_files(name)
    s = files["kind"].Session(files["config"], files["mix"], 12345678901,
                              "cpu")
    s.setup()
    s.run_window(0.2)
    s.release()
    sound, control = s.readings(), s.readings(control="tf32")
    assert all(control[k] > 3 * v for k, v in sound.items()), (sound,
                                                               control)
