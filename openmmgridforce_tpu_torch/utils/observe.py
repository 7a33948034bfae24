"""Observability: the program's spans, trace capture, trajectory
reporters.

``trace`` and ``capture_trace`` sit on ``torch.profiler``; the reporters
write the columns of the OpenMM StateDataReporter that the reference
sampler used, and xyz frames like its trajectory dumps.

Spans are named ``omgf.<layer>[.<stage>]`` (README, "Observability"). A
span costs a flag check when no profiler session runs and no block is
being captured (about 0.2 us of host time on the card's host): no
``RecordFunction`` is made. While ``mm/graphs.py``
captures a block, each span also keeps the range of the capture's device
nodes it issued, so a trace of the block's replays splits into the spans'
terms (``recorded_spans``).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import warnings

import numpy as np
import torch
from torch.autograd import profiler as _profiler

# while mm/graphs.py captures a block: the block's list of [span, first
# device node, device nodes] entries and the function that counts the
# capture's device nodes so far
_CAPTURE = contextvars.ContextVar("omgf_capture", default=None)

_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "_range", "_entry", "_count")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._range = self._entry = None
        capture = _CAPTURE.get()
        if capture is not None:
            spans, self._count = capture
            self._entry = [self.name, self._count(), None]
            spans.append(self._entry)
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._entry is not None:
            self._entry[2] = self._count() - self._entry[1]
        return False


def trace(name: str):
    """The program's span ``name`` around the body of a ``with``: a range
    in the profiler's timeline (``capture_trace``) while a session runs,
    and while a block is captured the range of its device nodes.
    Otherwise a shared no-op, after a check of those two states."""
    if not _profiler._is_profiler_enabled and _CAPTURE.get() is None:
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def node_spans(count):
    """Inside, every span keeps ``[name, first node, nodes]`` in the list
    this yields, in the order the spans were entered: ``count()`` gives
    the device nodes captured so far (``mm/graphs.py`` captures a block
    inside)."""
    spans = []
    token = _CAPTURE.set((spans, count))
    try:
        yield spans
    finally:
        _CAPTURE.reset(token)


def recorded_spans() -> dict:
    """The spans of every recorded segment block alive, by the serial
    number its replays carry (the span ``omgf.replay.<serial>`` around
    each replay while a profiler session runs):
    ``{serial: (device nodes, ((span, first node, nodes), ...))}``, the
    spans in the order they were entered, so an inner span follows the
    span it is nested in. A block's device nodes are its kernels, copies
    and fills, in the order a replay runs them. A block whose nodes
    cannot be counted so (one that holds a conditional WHILE node,
    ``mm/graphs.py::while_loop``) maps to None."""
    from ..mm import graphs

    return {serial: blk.nodes for serial, blk in list(graphs._BLOCKS.items())
            if blk.graph is not None}


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Profile the host and, where there is one, the CUDA card, and write
    a Chrome trace to ``log_dir/trace.json``. Yields the profiler.

    While recorded segments with conditional WHILE nodes
    (``mm/graphs.py::while_loop``) are alive, the card is not traced and
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
