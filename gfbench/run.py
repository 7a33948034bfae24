"""Run one cell of the benchmark of openmmgridforce_tpu_torch.

    python gfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1`` the
traced window's ``busy_s`` and ``window_s``), ``breakdown`` with
``--trace 1``, and last ``checks``, each number compared beside its
limit; the same comparisons are the last lines of standard error. Exits
non-zero with no result where there is no CUDA device, fewer than the cell
asks for, or where a module of JAX or of the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One host thread for the thread pools of torch and numpy, set before they
# load: with the default of a thread a core, torch's pool kept about four
# cores busy beside the thread that launches the card's work, and the
# generation cells, whose pace the host sets, ran slower by whole runs.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if a.seed < 0:
        p.error("--seed takes a whole number >= 0")

    import torch

    from gfbench import harness

    torch.set_num_threads(1)

    files = harness.cell(a.workload)
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gfbench: {a.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = harness.execute(a.workload, a.seed, a.seconds,
                                     bool(a.trace), "cuda", STARTED,
                                     files=files)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"gfbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    print(f"check failed {result['failed']} limit 0", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
