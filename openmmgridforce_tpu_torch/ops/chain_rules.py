"""Exact chain rules for composed scalar transforms of 27-derivative fields.

Computes all 27 mixed partial derivatives (orders <= 2 per axis) of
V = g(U(x, y, z)) from the 27 derivatives of U by the multivariate
Faa di Bruno formula:

    d^lambda (g o U) = sum over set partitions pi of the variable multiset
                       g^(|pi|)(U) * prod_{B in pi} d^B U

The partition tables are generated once and the composition is a small
elementwise expression. Two transforms are provided:
  * tanh cap      V = U_max * tanh(U / U_max)
  * inverse power V = sign(U) * |U|^p
plus their value-only forms.
"""

from __future__ import annotations

import functools
from collections import Counter

import torch

from .derivatives27 import DERIV_ORDERS, N_DERIVS, ORDER_TO_INDEX


# ----------------------------------------------------------------------
# Partition-table generation
# ----------------------------------------------------------------------

def _set_partitions(items):
    """Yield all set partitions of a list (standard recursive scheme)."""
    if len(items) == 1:
        yield [items]
        return
    first, rest = items[0], items[1:]
    for smaller in _set_partitions(rest):
        for i, block in enumerate(smaller):
            yield smaller[:i] + [[first] + block] + smaller[i + 1:]
        yield [[first]] + smaller


def _orders_of_block(block):
    """Multiset of axis labels -> (a, b, c) order triple."""
    c = Counter(item[0] for item in block)
    return (c.get("x", 0), c.get("y", 0), c.get("z", 0))


@functools.lru_cache(maxsize=1)
def faa_di_bruno_tables():
    """For each of the 27 target derivative slots, the collapsed partition
    expansion: a list of (num_blocks, coefficient, tuple(U-slot indices)).

    Slot 0 (the value) is excluded; V = g(U) directly.
    """
    tables = {}
    for d, (a, b, c) in enumerate(DERIV_ORDERS):
        if d == 0:
            continue
        # distinct labelled variable instances, e.g. (2,1,0) -> x0,x1,y0
        variables = ([("x", i) for i in range(a)]
                     + [("y", i) for i in range(b)]
                     + [("z", i) for i in range(c)])
        counter: Counter = Counter()
        for partition in _set_partitions(variables):
            signature = tuple(sorted(
                ORDER_TO_INDEX[_orders_of_block(block)]
                for block in partition))
            counter[signature] += 1
        tables[d] = [
            (len(sig), coeff, sig) for sig, coeff in sorted(counter.items())
        ]
    return tables


def compose(g_value, g_derivs, U):
    """Apply Faa di Bruno: V = g(U) with all 27 mixed derivatives.

    Args:
      g_value: g(U[..., 0]), shape [...].
      g_derivs: [g1, ..., g6], g^(k) evaluated at U[..., 0], each [...].
      U: [..., 27] input derivatives in the canonical order.

    Returns V [..., 27]. Each term starts from g^(k): where the transform
    is saturated g^(k) is 0 and the term stays 0, whereas a product of
    U slots formed first can overflow to inf and give inf * 0.
    """
    tables = faa_di_bruno_tables()
    slots = U.unbind(-1)
    out = [g_value]
    for d in range(1, N_DERIVS):
        acc = None
        for num_blocks, coeff, sig in tables[d]:
            term = g_derivs[num_blocks - 1]
            for s in sig:
                term = term * slots[s]
            if coeff != 1:
                term = coeff * term
            acc = term if acc is None else acc + term
        out.append(acc)
    return torch.stack(out, dim=-1)


# ----------------------------------------------------------------------
# tanh capping: V = U_max * tanh(U / U_max)
# ----------------------------------------------------------------------

def safe_tanh(x):
    """tanh with explicit saturation to +-1 beyond |x| > 20."""
    t = torch.tanh(x.clamp(-20.0, 20.0))
    one = torch.ones_like(x)
    return torch.where(x > 20.0, one, torch.where(x < -20.0, -one, t))


def tanh_derivatives(u):
    """T[k] = d^k tanh(u)/du^k for k = 0..6, zero for k >= 1 where
    |u| > 20 (saturated). Returns a list of 7 tensors."""
    sat_hi = u > 20.0
    sat_lo = u < -20.0
    sat = sat_hi | sat_lo
    t = torch.tanh(u.clamp(-20.0, 20.0))
    t2 = t * t
    t4 = t2 * t2
    s2 = 1.0 - t2
    one = torch.ones_like(t)
    zero = torch.zeros_like(t)
    T0 = torch.where(sat_hi, one, torch.where(sat_lo, -one, t))
    Ts = [
        s2,
        -2.0 * s2 * t,
        2.0 * s2 * (3.0 * t2 - 1.0),
        -8.0 * s2 * t * (3.0 * t2 - 2.0),
        8.0 * s2 * (15.0 * t4 - 15.0 * t2 + 2.0),
        -16.0 * s2 * t * (45.0 * t4 - 60.0 * t2 + 17.0),
    ]
    return [T0] + [torch.where(sat, zero, Tk) for Tk in Ts]


def apply_tanh_cap(U, cap, low_energy_passthrough=True):
    """Cap all 27 derivatives: V = cap * tanh(U / cap). U: [..., 27].

    With ``low_energy_passthrough`` the raw derivatives are returned
    unchanged where U/cap < 0.1, so values below 0.1 cap, all negative
    values among them, are never capped on the analytic-derivative path
    (the value-only path always applies tanh).
    """
    u = U[..., 0] / cap
    T = tanh_derivatives(u)
    inv = 1.0 / cap
    # g^(k)(U) = T[k] / cap^(k-1)
    g_derivs = [T[k] * inv ** (k - 1) for k in range(1, 7)]
    V = compose(cap * T[0], g_derivs, U)
    if low_energy_passthrough:
        V = torch.where((u < 0.1)[..., None], U, V)
    return V


def tanh_cap_value(value, cap):
    """Value-only capping V = cap * tanh(value / cap)."""
    return cap * safe_tanh(value / cap)


# ----------------------------------------------------------------------
# inverse power: V = sign(U) * |U|^p
# ----------------------------------------------------------------------

def invpower_g_derivatives(U0, p):
    """g(U) = sign(U) * |U|^p with |U| clamped to >= 1e-10, and its
    derivative factors g^(k) = p (p-1) ... (p-k+1) |U|^(p-k).

    The sign of U is applied to the value only; the derivative factors use
    |U| powers without sign factors (exact for U > 0, the intended regime
    of LJ-repulsion-style grids).
    """
    sign = torch.where(U0 >= 0.0, 1.0, -1.0).to(U0.dtype)
    absU = U0.abs().clamp_min(1e-10)
    g_value = sign * absU ** p
    g_derivs = []
    fall = 1.0
    for k in range(1, 7):
        fall = fall * (p - (k - 1))
        g_derivs.append(fall * absU ** (p - k))
    return g_value, g_derivs


def apply_invpower(U, p):
    """Transform all 27 derivatives for V = sign(U)|U|^p. U: [..., 27]."""
    g_value, g_derivs = invpower_g_derivatives(U[..., 0], p)
    return compose(g_value, g_derivs, U)


def invpower_value(value, p):
    """sign(v)|v|^p with the evaluation kernel's 1e-10 dead zone: values
    with |v| < 1e-10 map to 0."""
    av = value.abs()
    live = av >= 1e-10
    av_safe = torch.where(live, av, torch.ones_like(av))
    return torch.where(live, torch.sign(value) * av_safe ** p,
                       torch.zeros_like(value))
