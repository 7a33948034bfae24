"""The profiler's view of a traced window, reduced to what the per-layer
readers and the result's breakdown need.

Copied in idea from ``chip_smoke.py::_profile`` / ``_window_profile``
(:1559-1595), with one repair: the device's busy time is the union of its
operations' intervals inside the window, not the sum of their durations,
and the window is the host span around the traced work (the
``gfbench.window`` span), not a host clock that takes in the profiler's
own start and stop.

The card is traced by the profiler only while no recorded segment that
holds a conditional WHILE node (the constraint solver's stop) is alive,
as ``openmmgridforce_tpu_torch.utils.capture_trace`` has it: the profiler
sees one pass of a WHILE body per launch of a recording made before its
session, and a session over such replays has ended a process (PERF.md).
While one is alive the window traces the host, and the card's busy
intervals are those of the benchmark's own spans (``traced.mark``), timed
by CUDA events on the current stream at each span's entry and exit
(``busy_from`` "events"): a count of device operations is then None, and
the busy time an upper bound, since a span's interval counts whole, the
card's waits for the host inside it included.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

import torch

WINDOW = "gfbench.window"


@dataclasses.dataclass
class Trace:
    device_ops: list          # (name, start_us, end_us), by start
    host_ops: list            # (name, start_us, end_us), by start
    window: tuple             # (start_us, end_us)
    # what the card's busy intervals come from: "profiler" (device_ops) or
    # "events" (marks, the benchmark's spans timed by CUDA events)
    busy_from: str = "profiler"
    marks: list = dataclasses.field(default_factory=list)  # as device_ops

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def _merged(self):
        lo, hi = self.window
        out = []
        busy = self.device_ops if self.busy_from == "profiler" else self.marks
        for _, s, e in busy:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self._merged()) * 1e-6

    def ops(self, substring: str = ""):
        """(count, seconds) of the device operations whose name holds
        ``substring``, or None where the card was timed by events."""
        if self.busy_from != "profiler":
            return None
        hits = [e - s for n, s, e in self.device_ops if substring in n]
        return len(hits), sum(hits) * 1e-6

    def top_ops(self, n: int = 10):
        """The device operations that took most time, summed by name, or
        None where the card was timed by events."""
        if self.busy_from != "profiler":
            return None
        by = {}
        for name, s, e in self.device_ops:
            by[name] = by.get(name, 0.0) + (e - s) * 1e-6
        return sorted(([k[:120], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The longest idle stretches of the device inside the window,
        summed by the innermost host operation running when each began."""
        merged = self._merged()
        lo, hi = self.window
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:200]
        starts = [s for _, s, _ in self.host_ops]
        by = {}
        for length, start in gaps:
            # the running host operation that began last
            name = "(no host operation)"
            i = bisect.bisect_right(starts, start) - 1
            while i >= 0:
                if self.host_ops[i][2] >= start:
                    name = self.host_ops[i][0]
                    break
                i -= 1
            by[name] = by.get(name, 0.0) + length * 1e-6
        return sorted(([k[:120], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


class traced:
    """Profile the host around the body of a ``with``, and the card's
    work in it when the device is a card; the body's work is the window.
    The profiler traces the card unless recordings with WHILE nodes are
    alive at entry, when the card is timed by events around each ``mark``;
    ``force_card`` has the profiler trace the card all the same (the
    WHILE probe's). ``trace`` is set on exit."""

    def __init__(self, device, force_card=False):
        self.cuda = torch.device(device).type == "cuda"
        self.force_card = force_card
        self.events = False
        self.trace = None

    def __enter__(self):
        if self.cuda and not self.force_card:
            from gfbench import program

            self.events = program.while_recordings() > 0
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda and not self.events:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.span = torch.profiler.record_function(WINDOW)
        self.span.__enter__()
        if self.events:
            # the card is idle here, so the start event marks the window's
            # start on the card's clock
            torch.cuda.synchronize()
            self._marks = []
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        return self

    @contextlib.contextmanager
    def mark(self, name):
        """Where the card is timed by events, the body's interval on the
        card: events on the current stream at entry and exit."""
        if not self.events:
            yield
            return
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        try:
            yield
        finally:
            end.record()
            self._marks.append((name, begin, end))

    def __exit__(self, *exc):
        if self.cuda and exc[0] is None:
            torch.cuda.synchronize()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = reduce(self.prof.events())
            if self.events:
                lo = self.trace.window[0]
                at = self._start.elapsed_time
                self.trace.busy_from = "events"
                self.trace.marks = sorted(
                    ((name, lo + 1e3 * at(b), lo + 1e3 * at(e))
                     for name, b, e in self._marks), key=lambda m: m[1])
        return False


def reduce(events) -> Trace:
    device, host, window = [], [], None
    for ev in events:
        tr = ev.time_range
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation:
                device.append((ev.name, tr.start, tr.end))
        elif ev.name == WINDOW:
            window = (tr.start, tr.end)
        else:
            host.append((ev.name, tr.start, tr.end))
    device.sort(key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return Trace(device, host, window)
