"""Without a card a run fails and prints no result, and so does a
checkout that holds the benchmark without the program."""

import os
import shutil
import subprocess
import sys

from gfbench import harness


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "gfbench/run.py", "--workload",
                           "bspline-md-r1000", "--seed", "3000000001",
                           "--seconds", "1", "--trace", "0"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_a_run_with_no_card_exits_non_zero_without_a_result():
    out = _run(harness.CHECKOUT)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "correct" not in out.stdout


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(harness.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "gfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "correct" not in out.stdout
