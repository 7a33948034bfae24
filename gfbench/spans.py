"""The program's own spans in a traced window: the arithmetic that the
span readers share.

The program (``openmmgridforce_tpu_torch``) names its spans
``omgf.<layer>[.<stage>]``; each is a host range in the profiler's trace,
on the clock the device's operations are on. Here they are read three
ways: host time inside spans, device-idle time inside spans, and the
device operations of the segment blocks' CUDA-graph replays split into the
terms the program's spans held when each block was captured.

The split: every host call that enqueues device work (a kernel launch, a
copy, a fill, a graph launch) is a launch; on one stream the device runs
their operations in launch order, a launch of one operation each and a
graph launch one operation per device node of its block. The program marks
each replay with the span ``omgf.replay.<serial>`` and keeps, per block,
the range of device nodes each span issued while it was captured
(``openmmgridforce_tpu_torch.utils.observe.recorded_spans``). The
operations are dealt out to the launches in order; a launch of one
operation must get one of its own kind (kernel, copy or fill), no
operation may start before its launch (within the two clocks' offset and
drift), and every operation must be dealt. Where any of that fails the
split is None, never a part of one.

The two clocks' offset: the profiler's device clock can lie behind the
host's by hundreds of us (93 and 824 us seen on the card at a window's
start, where the device waits for the host). Where no deal holds at no
offset and the profiler missed no operation, the offset is
fitted from the launches' least lead (a device operation's start less its
launch's) over the launches whose operation found the device idle, since
those start as soon as the launch arrives; every other operation must
then start no earlier than its launch by that offset, within SKEW_US and
the drift.
"""

from __future__ import annotations

import bisect
import re

REPLAY = "omgf.replay."
# CUDA runtime and driver calls that enqueue device operations, by kind
_LAUNCH = re.compile(r"^cu(da)?(GraphLaunch|Memcpy|Memset|Launch"
                     r"(Cooperative)?Kernel)")
# how far a device operation's clock stamp may lie before its launch's,
# beyond the fitted offset: the jitter of a launch's lead, and the clocks'
# drift as a share of the time since the window began (up to 0.5% seen on
# the card in a process's later profiler sessions)
SKEW_US = 50.0
DRIFT = 0.01
# a device operation that starts this long after the one before it ended
# found the device idle: it started as soon as its launch arrived
IDLE_US = 10.0


# ----------------------------------------------------------------------
# Intervals
# ----------------------------------------------------------------------

def union(intervals):
    """Sorted, disjoint [start, end] of the union of (start, end)."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def length(merged) -> float:
    return sum(e - s for s, e in merged)


def intersect(a, b):
    """The intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def clip(trace, intervals):
    lo, hi = trace.window
    return union((max(s, lo), min(e, hi)) for s, e in intervals)


# ----------------------------------------------------------------------
# Spans
# ----------------------------------------------------------------------

def named(trace, name):
    """(start, end) of the host spans called ``name``, by start."""
    return [(s, e) for n, s, e in trace.host_ops if n == name]


def under(trace, prefix):
    """(start, end) of the host spans whose name starts with ``prefix``."""
    return [(s, e) for n, s, e in trace.host_ops if n.startswith(prefix)]


def has_spans(trace, name) -> bool:
    return any(n == name for n, _, _ in trace.host_ops)


def host_ms(trace, name) -> float:
    """Host ms inside the spans called ``name``, in the window (nested or
    overlapping spans counted once)."""
    return length(clip(trace, named(trace, name))) * 1e-3


def busy(trace):
    """Sorted, disjoint intervals in which some device operation ran,
    inside the window."""
    return clip(trace, ((s, e) for _, s, e in trace.device_ops))


def idle_ms(trace, intervals) -> float:
    """Device-idle ms inside the union of ``intervals``, in the window."""
    inside = clip(trace, intervals)
    return (length(inside) - length(intersect(inside, busy(trace)))) * 1e-3


# ----------------------------------------------------------------------
# Replays split into the spans' terms
# ----------------------------------------------------------------------

def op_kind(name: str) -> str:
    """The kind of a device operation by its trace name."""
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


def launch_kind(name: str):
    """The kind of operations a host call enqueues: "graph", "copy",
    "fill", "kernel", or None for a call that enqueues none."""
    m = _LAUNCH.match(name)
    if m is None:
        return None
    return {"GraphLaunch": "graph", "Memcpy": "copy",
            "Memset": "fill"}.get(m.group(2), "kernel")


def node_labels(total, spans):
    """Each device node's innermost span of a block: spans are
    (name, first, nodes) in the order they were entered, so a later one
    nested in an earlier one takes its nodes. Nodes of no span are None."""
    labels = [None] * total
    for name, first, n in spans:
        labels[first:first + n] = [name] * n
    return labels


def launches(trace, blocks):
    """The device operations of every launch in the traced window, dealt
    out in launch order: [(launch start, serial of the replayed block or
    None, index of its first operation in ``trace.device_ops``, number of
    operations)], or None where the operations do not align one to one
    with the launches and the replayed blocks' nodes. ``blocks`` is
    ``{serial: (device nodes, spans) or None}``.

    The profiler can miss the operations of the first launches after it
    starts and of the last before it stops (a few of them, on the card):
    such launches are left out, where exactly one number of operations
    missed at the start fits and no replay is among them. Operations after
    the window's end on the device's clock are the window's: that clock
    can run ahead of the host's."""
    lo, hi = trace.window
    replays = sorted((s, e, n[len(REPLAY):]) for n, s, e in trace.host_ops
                     if n.startswith(REPLAY))
    starts = [r[0] for r in replays]
    calls, end = [], float("-inf")
    for name, s, e in trace.host_ops:
        kind = launch_kind(name)
        # no launch, a driver call inside one, or a launch outside the window
        if kind is None or e <= end or not lo <= s <= hi:
            continue
        end = e
        serial, n = None, 1
        if kind == "graph":
            i = bisect.bisect_right(starts, s) - 1
            if i < 0 or replays[i][1] < e:
                return None      # a graph launch outside a replay's span
            try:
                serial = int(replays[i][2])
            except ValueError:
                return None
            block = blocks.get(serial)
            if block is None:
                return None
            n = block[0]
        calls.append((s, kind, serial, n))
    first = bisect.bisect_left([op[1] for op in trace.device_ops],
                               lo - SKEW_US)
    ops = trace.device_ops[first:]
    missed = sum(c[3] for c in calls) - len(ops)
    # at no offset first, so that a window that deals so splits as before;
    # an offset is fitted only where the profiler missed no operation: it
    # would trade against the operations missed at the start
    for fit in (False, True):
        tries = range(int(missed == 0) if fit else missed + 1)
        fits = [d for d in (_deal_from(calls, ops, a, first, lo, fit)
                            for a in tries) if d is not None]
        if fits:
            return fits[0] if len(fits) == 1 else None
    return None


def _deal_from(calls, ops, missed, first, start, fit):
    """``launches`` over the window's operations ``ops`` (the trace's from
    index ``first`` on) where the profiler missed the first ``missed``
    operations (and the last, as many as are left over); the window
    begins at ``start``. ``fit``: the clocks' offset is the least lead
    of the launches whose operation found the device idle (none ahead of
    the host's clock), else 0."""
    p, out, leads = -missed, [], []
    for s, kind, serial, n in calls:
        lo, p = p, p + n
        if p <= 0 or lo >= len(ops):
            if serial is not None:
                return None      # a replay missed
            continue
        if lo < 0 or p > len(ops):
            return None          # a replay missed in part
        if serial is None and op_kind(ops[lo][0]) != kind:
            return None
        idle = lo == 0 or ops[lo][1] - ops[lo - 1][2] > IDLE_US
        leads.append((ops[lo][1] - s, s, idle))
        out.append((s, serial, first + lo, n))
    offset = min([0.0] + [lead for lead, _, idle in leads if idle]) \
        if fit else 0.0
    if any(lead < offset - SKEW_US - DRIFT * (s - start)
           for lead, s, _ in leads):
        return None              # an operation before its launch
    return out


def deal(trace, blocks):
    """The traced window's replays: [(serial, index of its first operation
    in ``trace.device_ops``)], or None (``launches``)."""
    dealt = launches(trace, blocks)
    if dealt is None:
        return None
    return [(serial, p) for _, serial, p, _ in dealt if serial is not None]


def replay_terms(trace, blocks):
    """Device seconds of the traced window's replays by the innermost
    span each node was captured under ({span or None: seconds}), or None
    where the replays cannot be split (``deal``)."""
    dealt = deal(trace, blocks) if blocks else None
    if not dealt:
        return None
    labels = {k: node_labels(*blocks[k]) for k in {k for k, _ in dealt}}
    ops, out = trace.device_ops, {}
    for serial, p in dealt:
        for k, label in enumerate(labels[serial]):
            _, s, e = ops[p + k]
            out[label] = out.get(label, 0.0) + (e - s) * 1e-6
    return out


def eager_terms(trace, prefix="omgf.", blocks=None):
    """Device seconds of the operations of launches outside graphs by the
    innermost span named ``prefix...`` running when each was launched
    ({span or None: seconds}), or None (``launches``). ``blocks``: the
    recorded blocks whose replays the window holds beside them."""
    dealt = launches(trace, blocks or {})
    if dealt is None:
        return None
    named_ = [(s, e, n) for n, s, e in trace.host_ops
              if n.startswith(prefix) and not n.startswith(REPLAY)]
    ops, out = trace.device_ops, {}
    for start, serial, p, _ in dealt:
        if serial is not None:
            continue
        inner = None
        for s, e, n in named_:
            if s > start:
                break
            if e >= start:
                inner = n
        _, s, e = ops[p]
        out[inner] = out.get(inner, 0.0) + (e - s) * 1e-6
    return out


def recorded_blocks():
    """The program's recorded blocks ({serial: (device nodes, spans) or
    None}), or None where the program keeps none (a program without
    spans inside its recordings)."""
    try:
        from openmmgridforce_tpu_torch.utils import observe
    except ImportError:
        return None
    read = getattr(observe, "recorded_spans", None)
    return read() if read is not None else None


def term_ms(run, span):
    """Device ms a step of the traced MD window's replayed nodes that were
    captured under ``span`` (innermost), or None."""
    t, traced = run.trace, run.traced
    if t is None or not t.device_ops or not traced or "steps" not in traced:
        return None
    blocks = recorded_blocks()
    if not blocks or not any(b is not None and any(x[0] == span
                                                   for x in b[1])
                             for b in blocks.values()):
        return None
    terms = replay_terms(t, blocks)
    if terms is None:
        return None
    return terms.get(span, 0.0) * 1e3 / traced["steps"]


def per_receptor_host_ms(run, name):
    """Host ms a traced conformation inside the spans called ``name``, or
    None where there are none or the device was not traced."""
    t, traced = run.trace, run.traced
    if t is None or not t.device_ops or not traced \
            or "receptors" not in traced or not has_spans(t, name):
        return None
    return host_ms(t, name) / traced["receptors"]
