"""The check of loaded modules by whole top-level names, and a run that
loads neither JAX nor the JAX package."""

import subprocess
import sys

from gfbench import harness


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("openmmgridforce_tpu_torch", "openmmgridforce_tpu_torch.ops",
                 "jaxtyping", "jax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "openmmgridforce_tpu", raising=False)
    for name in [m for m in sys.modules
                 if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "openmmgridforce_tpu.ops", sys)
    assert harness.forbidden_modules() == ["jax", "openmmgridforce_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "from gfbench.tests.tiny import tiny_run;"
            "from gfbench import harness;"
            "tiny_run('bspline-md-r1000', seconds=0.1);"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.CHECKOUT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
