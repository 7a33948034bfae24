"""Double-float32 ("two-float") arithmetic: error-free transforms and
double-word operations on float32 tensors.

The port of the JAX package's ``ops/twofloat.py``. A value is carried as an
unevaluated pair ``(hi, lo)`` of float32 tensors with ``hi = fl(hi + lo)``,
about 49 bits of significand (~1e-14 relative), so ``ops/compensated.py``
can evaluate in double-word precision with float32 arithmetic only.

The algorithms are the classical error-free transforms (Knuth's 2Sum, a
bit-mask Veltkamp split, Dekker's 2Prod) and the double-word operations of
Joldes, Muller & Popescu, "Tight and rigorous error bounds for basic
building blocks of double-word arithmetic" (ACM TOMS 2017).

They are exact only if no multiply and add are contracted into one fused
multiply-add, which evaluates the product unrounded. Every function here
is a sequence of eager PyTorch operations: each is its own kernel, and no
kernel contracts across operations. Do not apply ``torch.compile`` or
Triton to this module (both fuse elementwise chains and contract them).
As in the JAX package, the split is made on the bit pattern and 2Prod is
assembled from exact partial products with additions only, so a
contraction could not break the error-free transforms (it would only
round df_mul's cross term otherwise, within its bound).
``chip_smoke.py``'s ``twofloat_check`` holds the transforms on the card.

Tensors take the device of their inputs. ``df_sum`` reduces the last axis
(the JAX function sums a flattened array; for 1-D input the two agree).
"""

from __future__ import annotations

import numpy as np
import torch


def two_sum(a, b):
    """Error-free a + b: returns (s, e) with s = fl(a+b), s + e = a + b."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fast_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b| (or a == 0)."""
    s = a + b
    return s, b - (s - a)


def bitmask_split(a):
    """a = hi + lo, hi = a rounded to nearest at 12 significand bits.

    Computed on the bit pattern (add half an ulp at 12 bits, then mask;
    the carry into the exponent is the rounding up to the next binade), so
    there is no float multiply to contract. Every pairwise product of
    halves is exact in float32."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    hi = ((bits + 0x800) & -0x1000).view(torch.float32)
    return hi, a - hi


def two_prod(a, b):
    """a * b as a pair (p, e) with p + e = a*b + delta, |delta| <= ~2u^2
    |a*b| (u = 2^-24): the four exact partial products of the 12-bit
    halves, added with 2Sum chains (no rounding-significant multiply)."""
    ah, al = bitmask_split(a)
    bh, bl = bitmask_split(b)
    p1 = ah * bh
    p2 = ah * bl
    p3 = al * bh
    p4 = al * bl
    s23, e23 = two_sum(p2, p3)
    hi, e1 = two_sum(p1, s23)
    lo = (e1 + e23) + p4
    return fast_two_sum(hi, lo)


# ----------------------------------------------------------------------
# Double-word (df) operations on (hi, lo) pairs
# ----------------------------------------------------------------------

def df(hi, lo=None):
    """Promote a float32 tensor to a df pair."""
    hi = torch.as_tensor(hi, dtype=torch.float32)
    if lo is None:
        lo = torch.zeros_like(hi)
    return hi, torch.as_tensor(lo, dtype=torch.float32, device=hi.device)


def df_from_f64(x) -> tuple[np.ndarray, np.ndarray]:
    """Host-side exact split of float64 data into a df pair (numpy)."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def df_to(x):
    """Collapse a df pair to plain float32 (loses the low word)."""
    return x[0] + x[1]


def df_neg(x):
    return -x[0], -x[1]


def df_add(x, y):
    """AccurateDWPlusDW (JMP 2017 alg. 6): relative error ~3u^2."""
    s_hi, s_lo = two_sum(x[0], y[0])
    t_hi, t_lo = two_sum(x[1], y[1])
    c = s_lo + t_hi
    v_hi, v_lo = fast_two_sum(s_hi, c)
    return fast_two_sum(v_hi, t_lo + v_lo)


def df_sub(x, y):
    return df_add(x, df_neg(y))


def df_add_f(x, b):
    """df + float32 (DWPlusFP, JMP 2017 alg. 4): error <= 2u^2."""
    s_hi, s_lo = two_sum(x[0], b)
    return fast_two_sum(s_hi, s_lo + x[1])


def df_mul(x, y):
    """DWTimesDW (JMP 2017 alg. 12): relative error ~5u^2."""
    p_hi, p_lo = two_prod(x[0], y[0])
    t = x[0] * y[1] + x[1] * y[0]
    return fast_two_sum(p_hi, p_lo + t)


def df_mul_f(x, b):
    """df * float32 (DWTimesFP, JMP 2017 alg. 9): relative error ~2u^2."""
    p_hi, p_lo = two_prod(x[0], b)
    return fast_two_sum(p_hi, p_lo + x[1] * b)


def df_scale_pow2(x, c):
    """Exact multiply by a power of two (2.0, 0.5, ...)."""
    return x[0] * c, x[1] * c


def df_where(cond, x, y):
    return torch.where(cond, x[0], y[0]), torch.where(cond, x[1], y[1])


def df_sum(x):
    """Sum a df pair over its last axis by a binary tree of df_add: log2(n)
    batched double-word adds, each partial a double-word value (the same
    ~u^2 a level as a sequential sum)."""
    hi, lo = x
    n = hi.shape[-1]
    if n == 0:
        zero = torch.zeros(hi.shape[:-1], dtype=torch.float32,
                           device=hi.device)
        return zero, zero.clone()
    p = 1 << (n - 1).bit_length()
    if p != n:
        pad = hi.shape[:-1] + (p - n,)
        hi = torch.cat([hi, hi.new_zeros(pad)], dim=-1)
        lo = torch.cat([lo, lo.new_zeros(pad)], dim=-1)
    while p > 1:
        p //= 2
        hi, lo = df_add((hi[..., :p], lo[..., :p]),
                        (hi[..., p:], lo[..., p:]))
    return hi[..., 0], lo[..., 0]
