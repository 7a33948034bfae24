"""Recorded MD segments: the port's counterpart of the JAX package's
``lax.scan`` under ``jit`` (``openmmgridforce_tpu/mm/integrators.py``
:130-143, unrolled by 4).

A :class:`Segment` advances a carry of tensors (positions, velocities and
whatever else a caller threads through the steps) over static buffers, a
block of ``BLOCK`` steps at a time. On the card each block length is
recorded once as a CUDA graph and replayed; between replays the next
rows of noise are copied (or drawn) into a static noise block. On the CPU
the same block function is called directly, so the CPU tests cover the
buffer and noise bookkeeping. A capture or replay that fails raises: the
card never falls back to eager steps.

Inside a recording a loop that must stop on the device can call
:func:`while_loop`: a conditional WHILE node of the graph
(``csrc/graph_while.cu``, built by ``cuda_build``) while capturing, and a
host loop over the same operations while the block warms up. (The
constraint solver, its first user, now stops inside its own kernel.)

Spans (``utils/observe.py``): ``omgf.segment.record`` around a recording,
``omgf.step.integrate`` around each step and the carry's write-back inside
a block, and, while a profiler session runs, ``omgf.replay.<serial>``
around each replay. A capture keeps the device nodes each span issued
(``utils.observe.recorded_spans``), so a reader of a trace can split the
replays' operations into the spans' terms.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import gc
import inspect
import itertools
import time
import weakref

import torch

from ..utils import observe

# steps a recorded block holds: the unroll of the JAX package's scan
BLOCK = 4

# the _Block whose capture is under way, or the string "warmup" while a
# block runs once before its capture, or None
_RECORDING = contextvars.ContextVar("omgf_recording", default=None)

# set inside ``eager()``: blocks run as eager launches on the card
_EAGER = contextvars.ContextVar("omgf_eager", default=False)

# recordings made in this process and the host seconds they took (warm-up
# step, capture, instantiation): counters that chip_smoke.py reads
RECORDINGS = {"count": 0, "seconds": 0.0}

# graphs whose capture failed: PyTorch aborts the process when such a graph
# is destroyed, so they are kept
_FAILED = []

# recorded blocks that hold conditional WHILE nodes
_WHILE_BLOCKS = weakref.WeakSet()

# recorded blocks alive, by the serial number their replays' spans carry
# (utils.observe.recorded_spans reads their spans)
_BLOCKS = weakref.WeakValueDictionary()
_SERIALS = itertools.count()


def recording() -> bool:
    """Whether a segment block is being recorded (warmed up or captured):
    code that would synchronise with the host must stop on the device."""
    return _RECORDING.get() is not None


def warming_up() -> bool:
    """Whether a segment block is running once before its capture."""
    return isinstance(_RECORDING.get(), str)


def while_recordings() -> int:
    """How many recorded blocks that hold conditional WHILE nodes are
    alive (``utils.capture_trace`` refuses to trace the card while any
    is: PERF.md)."""
    gc.collect()
    return sum(1 for blk in _WHILE_BLOCKS if blk.graph is not None)


@contextlib.contextmanager
def eager():
    """Inside this context segments run their blocks as eager launches on
    the card, not as graph replays: the rate and the trajectory the
    recordings are held against (the same steps, noise and buffers)."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


def takes_noise(step_fn) -> bool:
    """Whether ``step_fn`` accepts a ``noise`` argument."""
    try:
        params = inspect.signature(step_fn).parameters
    except (TypeError, ValueError):
        return False
    return "noise" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


# ----------------------------------------------------------------------
# Conditional WHILE nodes and node counts (csrc/graph_while.cu)
# ----------------------------------------------------------------------

@functools.cache
def _graph_lib():
    from ..cuda_build import load

    lib = load("graph_while")
    vp, ull = ctypes.c_void_p, ctypes.c_ulonglong
    lib.omgf_graph_init.argtypes = []
    lib.omgf_while_begin.argtypes = [vp, ctypes.POINTER(ull),
                                     ctypes.POINTER(vp)]
    lib.omgf_capture_to_graph_begin.argtypes = [vp, vp]
    lib.omgf_set_condition.argtypes = [vp, ull, vp]
    lib.omgf_capture_end.argtypes = [vp]
    lib.omgf_capture_nodes.argtypes = [vp, ctypes.POINTER(ull)]
    for fn in (lib.omgf_graph_init, lib.omgf_while_begin,
               lib.omgf_capture_to_graph_begin, lib.omgf_set_condition,
               lib.omgf_capture_end, lib.omgf_capture_nodes):
        fn.restype = ctypes.c_int
    _check(lib.omgf_graph_init(), "loading the condition kernel")
    return lib


def _check(code, what):
    if code:
        raise RuntimeError(f"CUDA graph while node: {what} failed with "
                           f"error {code}")


@functools.cache
def _body_stream(device):
    return torch.cuda.Stream(device=device)


def _while_node(body):
    """Capture ``body`` as the body of a conditional WHILE node of the
    graph being captured on the current stream. The body's operations run
    on a second stream captured into the node's body graph, their memory
    from the block's pool of while bodies; the flag ``body`` returns is
    written into the node's handle at the end of every pass."""
    block = _RECORDING.get()
    _WHILE_BLOCKS.add(block)
    lib = _graph_lib()
    stream = torch.cuda.current_stream()
    device = stream.device
    handle, body_graph = ctypes.c_ulonglong(), ctypes.c_void_p()
    _check(lib.omgf_while_begin(stream.cuda_stream, ctypes.byref(handle),
                                ctypes.byref(body_graph)), "adding the node")
    child = _body_stream(device)
    pool = block.body_pool(device)
    torch._C._cuda_beginAllocateCurrentThreadToPool(device.index, pool)
    try:
        _check(lib.omgf_capture_to_graph_begin(child.cuda_stream,
                                               body_graph),
               "capturing the body")
        try:
            with torch.cuda.stream(child):
                flag = body()
                _check(lib.omgf_set_condition(child.cuda_stream,
                                              handle.value,
                                              flag.data_ptr()),
                       "launching the condition kernel")
        finally:
            _check(lib.omgf_capture_end(child.cuda_stream),
                   "ending the body's capture")
    finally:
        torch._C._cuda_endAllocateToPool(device.index, pool)
        torch._C._cuda_releasePool(device.index, pool)   # the body's ref


def _node_counter(block, stream):
    """A function that counts the device nodes (kernels, copies, fills)
    of ``block``'s graph being captured on ``stream`` so far, or returns
    -1 where they cannot be counted: once the graph holds a WHILE node
    (whose body a count of the graph's own nodes misses; the graph is not
    asked again), or where the count fails. A count never fails the
    capture."""
    lib, n = _graph_lib(), ctypes.c_ulonglong()

    def count():
        if block in _WHILE_BLOCKS:
            return -1
        if lib.omgf_capture_nodes(stream.cuda_stream, ctypes.byref(n)):
            return -1
        return n.value

    return count


def _node_spans(total, spans):
    """(device nodes, spans) of a capture, or None where a count failed."""
    if total < 0 or any(first < 0 or n is None or n < 0
                        for _, first, n in spans):
        return None
    return total, tuple(tuple(entry) for entry in spans)


def while_loop(body):
    """Run ``body`` until the 0-d bool tensor it returns is false; it runs
    at least once. Inside a capture this is a conditional WHILE node, so
    the stop happens on the device; otherwise a host loop that reads the
    flag after every pass."""
    if isinstance(_RECORDING.get(), _Block):
        _while_node(body)
        return
    while bool(body()):
        pass


# ----------------------------------------------------------------------
# Blocks and segments
# ----------------------------------------------------------------------

class _Block:
    """``length`` steps of a segment's ``advance`` over its static buffers;
    ``play`` replays the recording on the card, calls the function on the
    CPU. The segment is passed in, not held: a block and its segment form
    no reference cycle, so a dropped segment frees its recordings, and
    the payloads its step reads, at once."""

    def __init__(self, length):
        self.length = length
        self.graph = None
        self._body_pool = None
        self.serial = next(_SERIALS)
        self.replay_span = f"omgf.replay.{self.serial}"
        # (device nodes, ((span, first node, nodes), ...)) of the
        # recording, or None where they cannot be counted
        self.nodes = None

    def body_pool(self, device):
        """The memory pool of the block's while bodies (the capture's own
        pool is taken while it records): made at the first body and held,
        one reference, until the block is dropped."""
        if self._body_pool is None:
            pool = torch.cuda.graph_pool_handle()
            torch._C._cuda_beginAllocateCurrentThreadToPool(device.index,
                                                            pool)
            torch._C._cuda_endAllocateToPool(device.index, pool)
            self._body_pool = pool
            fin = weakref.finalize(self, torch._C._cuda_releasePool,
                                   device.index, pool)
            fin.atexit = False
        return self._body_pool

    def body(self, seg, steps=None):
        carry = seg.carry
        for u in range(self.length if steps is None else steps):
            with observe.trace("omgf.step.integrate"):
                carry = seg.advance(carry, None if seg.noise is None
                                    else seg.noise[u])
                if seg.frames is not None:
                    seg.frames[u].copy_(carry[0])
        with observe.trace("omgf.step.integrate"):
            for buf, new in zip(seg.carry, carry):
                if new is not buf:
                    buf.copy_(new)

    def record(self, seg):
        """Run one step of the block as it is (which loads every kernel the
        block launches and fills the caches its steps read), then capture
        the block on a side stream, counting the device nodes each span
        issues."""
        t0 = time.perf_counter()
        with observe.trace("omgf.segment.record"):
            self._record(seg)
        RECORDINGS["count"] += 1
        RECORDINGS["seconds"] += time.perf_counter() - t0

    def _record(self, seg):
        token = _RECORDING.set("warmup")
        try:
            self.body(seg, steps=1)
        finally:
            _RECORDING.reset(token)
        graph = torch.cuda.CUDAGraph()
        for gen in seg.generators:
            graph.register_generator_state(gen)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        count = _node_counter(self, stream)
        token = _RECORDING.set(self)
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin()
                try:
                    with observe.node_spans(count) as spans:
                        self.body(seg)
                    total = count()
                except BaseException:
                    _FAILED.append(graph)
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                graph.capture_end()
        finally:
            _RECORDING.reset(token)
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = graph
        self.nodes = (None if self in _WHILE_BLOCKS
                      else _node_spans(total, spans))
        _BLOCKS[self.serial] = self

    def play(self, seg):
        if self.graph is not None and not _EAGER.get():
            with observe.trace(self.replay_span):
                self.graph.replay()
        else:
            self.body(seg)


class Segment:
    """Static buffers and recorded blocks for running a step function.

    ``advance(carry, noise) -> carry`` advances a tuple of tensors by one
    step; ``carry`` gives their shapes, dtypes and device (the buffers are
    copies). ``noise_shape`` is one step's noise ([..., N, 3], or
    [n_inner, ..., N, 3] for r-RESPA), or None for a step that takes none.
    ``frames``: keep the first carry tensor of every step of a block, for
    trajectories. ``generators``: torch Generators the step itself draws
    from (registered with every recording).

    On a CUDA device every block length that ``run`` needs (``BLOCK``, and
    the remainder of a segment that is no multiple of it) is recorded once
    and replayed; on the CPU the block function runs as it is.
    """

    def __init__(self, advance, carry, noise_shape=None, frames=False,
                 generators=()):
        self.advance = advance
        self.carry = tuple(t.clone() for t in carry)
        x = self.carry[0]
        self.on_card = x.is_cuda
        self.block = BLOCK
        dtype = self.carry[1].dtype if len(self.carry) > 1 else x.dtype
        self.noise = (None if noise_shape is None else
                      torch.zeros((self.block,) + tuple(noise_shape),
                                  dtype=dtype, device=x.device))
        self.frames = (torch.zeros((self.block,) + tuple(x.shape),
                                   dtype=x.dtype, device=x.device)
                       if frames else None)
        self.generators = tuple(generators)
        self._blocks = {}

    def _block(self, length):
        blk = self._blocks.get(length)
        if blk is None:
            blk = self._blocks[length] = _Block(length)
        if self.on_card and blk.graph is None and not _EAGER.get():
            with torch.cuda.device(self.carry[0].device):
                blk.record(self)
        return blk

    def lengths(self, n_steps):
        """The block lengths a segment of ``n_steps`` replays."""
        out = []
        if n_steps >= self.block:
            out.append(self.block)
        if n_steps % self.block:
            out.append(n_steps % self.block)
        return out

    def run(self, carry, n_steps, noise=None, generator=None,
            on_block=None):
        """Advance ``carry`` by ``n_steps`` steps; returns new tensors.

        ``noise``: None (each block's rows drawn from ``generator``, or
        PyTorch's default generator) or [n_steps, *noise_shape].
        ``on_block(start, length, frames)`` is called after every block
        (``frames`` the per-step buffer, or None)."""
        if noise is not None and noise.shape[0] != n_steps:
            raise ValueError(f"noise has {noise.shape[0]} steps, not "
                             f"{n_steps}")
        for length in self.lengths(n_steps):     # record before loading
            self._block(length)
        for buf, t in zip(self.carry, carry):
            buf.copy_(t)
        done = 0
        while done < n_steps:
            n = min(self.block, n_steps - done)
            if self.noise is not None:
                if noise is None:
                    self.noise[:n].normal_(generator=generator)
                else:
                    self.noise[:n].copy_(noise[done:done + n])
            self._block(n).play(self)
            if on_block is not None:
                on_block(done, n, self.frames)
            done += n
        return tuple(t.clone() for t in self.carry)
