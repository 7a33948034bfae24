"""Observability: profiling scopes, trajectory reporters, timers.

``trace`` and ``capture_trace`` sit on ``torch.profiler``; the reporters
write the columns of the OpenMM StateDataReporter that the reference
sampler used, and xyz frames like its trajectory dumps.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings

import numpy as np
import torch


@contextlib.contextmanager
def trace(name: str):
    """Named profiler scope (a range in ``capture_trace``'s timeline)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Profile the host and, where there is one, the CUDA card, and write
    a Chrome trace to ``log_dir/trace.json``. Yields the profiler.

    While recorded segments with conditional WHILE nodes (constrained MD
    on the card, ``mm/graphs.py``) are alive, the card is not traced and
    a warning says so: the profiler sees one pass of a WHILE body per
    launch of a recording made before the session, and a session over
    such replays has ended the process with a segmentation fault
    (PERF.md)."""
    from ..mm import graphs

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        if graphs.while_recordings():
            warnings.warn("capture_trace: recorded segments with WHILE "
                          "nodes are alive; tracing the host only",
                          RuntimeWarning, stacklevel=3)
        else:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Wall-clock section timer with named accumulators."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        return " | ".join(
            f"{k}: {v:.3f}s/{self.counts[k]}x"
            for k, v in sorted(self.totals.items()))


class StateDataReporter:
    """Periodic state reporter mirroring the OpenMM reporter the reference
    sampler used (example/sampler.py:142-149): step, potential energy and
    temperature columns to a file or stream."""

    def __init__(self, fname_or_stream, report_interval: int,
                 separator: str = "     "):
        self._own = isinstance(fname_or_stream, str)
        self._fh = (open(fname_or_stream, "w") if self._own
                    else fname_or_stream)
        self.interval = report_interval
        self.sep = separator
        self._wrote_header = False

    def report(self, step: int, potential_energy: float,
               temperature: float):
        if not self._wrote_header:
            self._fh.write(self.sep.join(
                ['#"Step"', '"Potential Energy (kJ/mole)"',
                 '"Temperature (K)"']) + "\n")
            self._wrote_header = True
        self._fh.write(self.sep.join(
            [str(step), f"{potential_energy:.6f}",
             f"{temperature:.4f}"]) + "\n")
        self._fh.flush()

    def close(self):
        if self._own:
            self._fh.close()


def write_xyz_frame(fh, comment: str, positions_nm, symbols=None):
    """Append one frame in xyz format (Angstrom), like the reference's
    trajectory dumps (example/sampler.py:62-71)."""
    if isinstance(positions_nm, torch.Tensor):
        positions_nm = positions_nm.detach().cpu().numpy()
    pos = np.asarray(positions_nm) * 10.0
    n = len(pos)
    fh.write(f"{n}\n{comment}\n")
    for i, p in enumerate(pos):
        sym = symbols[i] if symbols is not None else "C"
        fh.write(f"{sym} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
