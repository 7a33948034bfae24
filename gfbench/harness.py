"""The benchmark's driver, found by name from data files.

A cell ``gfbench/workloads/<cell>.json`` names its configuration
(``gfbench/configs/<config>.json``), its traffic mix
(``gfbench/traffic/<mix>.json``, whose ``kind`` names the general
generator ``gfbench/traffic/<kind>.py``) and the limits of the numbers its
check compares. ``BENCHMARK.json`` at the checkout's root says which
metrics the cell reports; each metric is read by
``gfbench/metrics/<metric>.py``, whose ``read(run)`` returns a number, or
None where it finds nothing to read.

A run: set-up, the window of ``seconds``, with ``trace`` the mix's traced
window after it, the device's peak memory, the program's state dropped,
then the check against the plain reference.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# whole top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "openmmgridforce_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "gfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(name: str) -> dict:
    """The cell's files, found by its name: {"cell", "config", "mix",
    "kind"} (the kind as a module)."""
    c = load_json(ROOT / "workloads" / f"{name}.json")
    mix = load_json(ROOT / "traffic" / f"{c['traffic']}.json")
    return {"cell": c, "config": load_json(ROOT / "configs"
                                           / f"{c['config']}.json"),
            "mix": mix,
            "kind": load_module(ROOT / "traffic" / f"{mix['kind']}.py")}


def metric_names(bench: dict, name: str, trace: bool) -> list:
    """The metrics BENCHMARK.json has cell ``name`` report: with
    ``trace`` its per-layer metrics, else its end-to-end ones."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return [m["name"] for m in e2e]
    moved = {m["name"] for m in e2e}
    return [m["name"] for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved
                             else [])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What the metric readers read: the window's record, the traced
    window's trace, spans and counters, and the session's geometry."""

    def __init__(self, files, seed, device):
        self.device = torch.device(device)
        self.config, self.mix = files["config"], files["mix"]
        self.session = files["kind"].Session(self.config, self.mix, seed,
                                             device)
        self.setup_s = None
        self.trace = None
        # the traced window (gfbench.trace.traced) while it is open
        self.tracing = None
        self.spans = {}

    @property
    def window(self):
        return self.session.window

    @property
    def traced(self):
        return self.session.traced

    @contextlib.contextmanager
    def span(self, name, sync=False):
        """A span of the benchmark's own around a call into a layer: a
        range in the profiler's trace; where the traced window times the
        card by events, the body's interval on the card
        (``gfbench.trace.traced.mark``); and, with ``sync``, a
        synchronised host time kept under ``spans[name]``."""
        cuda = self.device.type == "cuda"
        if sync and cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        marked = (self.tracing.mark(name) if self.tracing is not None
                  else contextlib.nullcontext())
        with torch.profiler.record_function("gfbench." + name), marked:
            yield
            if sync and cuda:
                torch.cuda.synchronize()
        if sync:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)


def execute(name, seed, seconds, trace, device, started, files=None):
    """One run of cell ``name``. Returns (result dict, checks dict)."""
    from gfbench import trace as tr

    files = files or cell(name)
    bench = load_json(CHECKOUT / "BENCHMARK.json")
    run = Run(files, seed, device)
    cuda = run.device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    s = run.session
    t0 = time.perf_counter()
    s.setup()
    run.setup_s = time.perf_counter() - started
    print(f"setup_s {run.setup_s:.3f}: {t0 - started:.3f} to start the "
          f"card and import, {run.setup_s - (t0 - started):.3f} in the "
          "cell's set-up", file=sys.stderr)
    s.run_window(seconds)
    if trace:
        window = run.tracing = tr.traced(device)
        s.run_traced(run.span, window)
        run.tracing = None
        run.trace = window.trace
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {}
    for m in metric_names(bench, name, trace):
        unit = next(x["unit"] for x in bench["end_to_end"] + bench["per_layer"]
                    if x["name"] == m)
        value = load_module(ROOT / "metrics" / f"{m}.py").read(run)
        if value is not None:
            metrics[m] = {"value": value, "unit": unit}
    s.release()
    readings = s.readings()
    limits = files["cell"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in readings.items()}
    failed = s.window["failed"]
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s()
        dev["busy_from"] = run.trace.busy_from
    result = {"correct": correct, "attempted": s.window["items"],
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        # no device_ops where the card was timed by events: the profiler
        # would have counted one pass of each WHILE body
        breakdown = {"device_ops": run.trace.top_ops(),
                     "idle_gaps": run.trace.idle_gaps()}
        result["breakdown"] = {k: v for k, v in breakdown.items()
                               if v is not None}
    result["checks"] = checks
    return result, checks
