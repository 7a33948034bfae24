"""Readings that a cell's limits are set from, in one process on the card.

    python gfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 2]

For each seed: the cell's set-up and a short window at the cell's own
load, then the numbers its check compares, for the program and, on the
control seeds, for the control (the plain reference computed in TF32 in
the program's place; ``gfbench/reference/precision.py``). Prints one JSON
line a reading. The benchmark's own runs do not run the control.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)

    import torch

    from gfbench import harness

    if not torch.cuda.is_available():
        print("gfbench: calibration needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    files = harness.cell(a.workload)
    controls = {int(s) for s in a.control_seeds.split(",") if s}
    seeds = [int(s) for s in a.seeds.split(",")]
    seeds += sorted(controls - set(seeds))
    for seed in seeds:
        s = files["kind"].Session(files["config"], files["mix"], seed, "cuda")
        t0 = time.perf_counter()
        s.setup()
        t1 = time.perf_counter()
        s.run_window(a.seconds)
        s.release()
        t2 = time.perf_counter()
        out = {"workload": a.workload, "seed": seed, "setup_s": t1 - t0,
               "window": {k: v for k, v in s.window.items()
                          if k != "durations"},
               "program": s.readings()}
        out["check_s"] = time.perf_counter() - t2
        if seed in controls:
            out["control_tf32"] = s.readings(control="tf32")
        print(json.dumps(out), flush=True)
        del s
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
