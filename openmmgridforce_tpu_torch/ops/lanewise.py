"""Elementwise functions whose host result does not depend on the layout.

ATen's CPU kernels of a binary elementwise function (``atan2``, ``pow``)
run a vectorised loop (SLEEF's functions) over whole blocks of two vectors
and the scalar function (``std::atan2``, ``std::pow``) over the remainder,
and the two round some arguments differently (about 2% for ``atan2``). An
element's value then depends on where it lies in the array: on how many
replicas the batch holds, which a rank of a mesh shares with the others.
``lanewise`` pads the flattened arguments to whole blocks and passes them
in slices that ATen does not split over threads, so every element takes
the vectorised path. On the card a kernel computes every element alike,
and the function runs as it is.
"""

from __future__ import annotations

import torch

# elements ATen's vectorised loop takes at once, at most (two AVX-512
# vectors of float32), and a slice that it does not split over threads
# (a multiple of the block, below ATen's grain of 32,768)
BLOCK = 64
SLICE = 16384


def lanewise(fn, *args):
    """``fn(*args)`` for an elementwise ``fn`` of broadcastable tensors (and
    Python numbers, passed as they are), every element computed by the
    vectorised path on the host (padding with ones, which every such
    function takes)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    shape = torch.broadcast_shapes(*(a.shape for a in tensors))
    n = 1
    for s in shape:
        n *= s
    if tensors[0].is_cuda or n == 0:
        return fn(*args)
    pad = -n % BLOCK
    flat = [torch.cat([a.expand(shape).reshape(-1), a.new_ones(pad)])
            if isinstance(a, torch.Tensor) else a for a in args]
    out = torch.cat([
        fn(*(f[i:i + SLICE] if isinstance(f, torch.Tensor) else f
             for f in flat))
        for i in range(0, n + pad, SLICE)])
    return out[:n].reshape(shape)
