"""Whether ``torch.profiler`` can trace replays of a recorded segment whose
graph holds conditional WHILE nodes (``mm/graphs.py::while_loop``), and
whether it sees the kernels of their bodies.

Each case runs in child processes of its own (a crash of the profiler ends
only the child) and is repeated ``--trials`` times. A case records a toy
segment of 21 x 47 x 3 positions: per step two kernels of noise, then a
loop of ``PASSES`` passes of 11 kernels (eight elementwise updates, a
counter, a comparison and, inside a WHILE node, the kernel that writes the
node's condition), recorded as a WHILE node, or unrolled into plain
launches for the control. It replays ``WINDOW`` steps ``SESSIONS`` times,
each under a profiler session (CUDA activity only) unless the case says
otherwise, and prints the kernels the profiler saw beside those the steps
launch. The cases:

- ``while``: a WHILE recording, profiled (the sampler's recorded ladder);
- ``while_unprofiled``: the same, never profiled;
- ``while_pool_kept``: profiled, the while bodies' memory pool never
  released (``torch._C._cuda_releasePool`` made a no-op);
- ``while_second``: two WHILE recordings, the first profiled once, then
  the second (``chip_smoke.py``'s profiled trial, then its
  ``bpmf_segments`` before it stopped profiling recordings);
- ``while_record_profiled``: the recording itself made inside a session;
- ``unrolled``: no WHILE node, profiled.

The summary line gives, per case, the children's exit codes (a negative
code is the signal that ended the child: -11 a segmentation fault) and
the kernels seen against expected.

    python -m openmmgridforce_tpu_torch.while_profile_check [--trials N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PASSES = 8
WINDOW = 200
SESSIONS = 3
CASES = ("while", "while_unprofiled", "while_pool_kept", "while_second",
         "while_record_profiled", "unrolled")


def _segment(torch, graphs, unrolled, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((21, 47, 3), generator=gen, device="cuda")

    def advance(carry, noise):
        state = (carry[0] + 1e-3 * noise).clone()
        count = torch.zeros((), dtype=torch.int64, device="cuda")

        def body():
            for _ in range(4):
                state.mul_(0.999).add_(1e-4)
            count.add_(1)
            return count < PASSES

        if unrolled:
            for _ in range(PASSES):
                body()
        else:
            graphs.while_loop(body)
        return (state,)

    seg = graphs.Segment(advance, (x,), noise_shape=x.shape)
    return seg, x, gen


def _kernels(torch, prof):
    return sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA)


def child(case: str) -> dict:
    import torch

    from .mm import graphs

    if case == "while_pool_kept":
        torch._C._cuda_releasePool = lambda *args: None
    unrolled = case == "unrolled"
    acts = [torch.profiler.ProfilerActivity.CUDA]
    # per step: noise (mul, add), clone, zeros and PASSES x (8 updates,
    # counter, comparison, and the condition kernel in a WHILE node); per
    # block of 4 steps a noise draw and the carry's copy back
    per_step = 4 + PASSES * (10 + (0 if unrolled else 1))
    seg, x, gen = _segment(torch, graphs, unrolled, 0)
    if case == "while_record_profiled":
        seg = graphs.Segment(seg.advance, (x,), noise_shape=x.shape)
        with torch.profiler.profile(activities=acts):
            seg.run((x,), WINDOW, generator=gen)
            torch.cuda.synchronize()
    else:
        seg.run((x,), graphs.BLOCK, generator=gen)        # records
    plan = [seg] * SESSIONS
    if case == "while_second":
        second = _segment(torch, graphs, unrolled, 1)[0]
        second.run((x,), graphs.BLOCK, generator=gen)
        plan = [seg] + [second] * (SESSIONS - 1)
    torch.cuda.synchronize()
    seen = []
    for s in plan:
        if case == "while_unprofiled":
            out = s.run((x,), WINDOW, generator=gen)
            torch.cuda.synchronize()
            continue
        with torch.profiler.profile(activities=acts) as prof:
            out = s.run((x,), WINDOW, generator=gen)
            torch.cuda.synchronize()
        seen.append(_kernels(torch, prof))
    return {"case": case, "finite": bool(torch.isfinite(out[0]).all()),
            "kernels_seen": seen,
            "kernels_expected": (WINDOW * per_step
                                 + 2 * WINDOW // graphs.BLOCK)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trials", type=int, default=4)
    parser.add_argument("--child", choices=CASES, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("while_profile_check needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    summary = {"torch": torch.__version__, "cuda": torch.version.cuda,
               "device": torch.cuda.get_device_name(0), "cases": {}}
    for case in CASES:
        rcs, results = [], []
        for _ in range(args.trials):
            proc = subprocess.run(
                [sys.executable, "-m", __spec__.name, "--child", case],
                capture_output=True, text=True, timeout=600, cwd=root,
                env=env)
            rcs.append(proc.returncode)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("{")]
            if lines:
                results.append(json.loads(lines[-1]))
            elif proc.returncode:
                print(json.dumps({"case": case, "rc": proc.returncode,
                                  "stderr": proc.stderr[-600:]}),
                      flush=True)
        row = {"exit_codes": rcs,
               "crashed": sum(1 for rc in rcs if rc != 0),
               "kernels_seen": [r["kernels_seen"] for r in results],
               "kernels_expected": (results[0]["kernels_expected"]
                                    if results else None)}
        print(json.dumps({"case": case, **row}), flush=True)
        summary["cases"][case] = row
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
