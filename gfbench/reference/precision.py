"""The arithmetic a reference computation runs in.

``Arith("float64")`` is the reference. ``Arith("tf32")`` is its control:
float32 with every contraction (the sum over receptor atoms, the
interpolation's sum over stencil values) taken as the card's TF32 tensor
cores take it, its operands rounded to TF32's 10-bit fraction (round to
nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and the sum kept in
float32. The configuration states float32 with TF32 off, and TF32 is the
nearest precision below it.
"""

from __future__ import annotations

import torch


class Arith:
    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown arithmetic {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def rnd(self, x):
        """An operand of a contraction: as it is in float64, rounded to
        TF32 in the control (the gradient passes straight through)."""
        if self.name == "float64":
            return x
        return x + (tf32(x.detach()) - x).detach()


def tf32(x):
    """Round float32 ``x`` to TF32's 10 fraction bits, to nearest, ties
    away from zero."""
    x = x.to(torch.float32).contiguous()
    rounded = ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)
