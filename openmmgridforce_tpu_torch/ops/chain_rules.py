"""Value transforms of capped grids: the tanh cap and the inverse power.

The value half of the JAX module; the 27-derivative Faa di Bruno chain
rules wait for the derivative slice (ROADMAP, Queue A item 8).
"""

from __future__ import annotations

import torch


def safe_tanh(x):
    """tanh with explicit saturation to +-1 beyond |x| > 20."""
    t = torch.tanh(x.clamp(-20.0, 20.0))
    one = torch.ones_like(x)
    return torch.where(x > 20.0, one, torch.where(x < -20.0, -one, t))


def tanh_cap_value(value, cap):
    """Value-only capping V = cap * tanh(value / cap)."""
    return cap * safe_tanh(value / cap)


def invpower_value(value, p):
    """sign(v)|v|^p with the evaluation kernel's 1e-10 dead zone: values
    with |v| < 1e-10 map to 0."""
    av = value.abs()
    live = av >= 1e-10
    av_safe = torch.where(live, av, torch.ones_like(av))
    return torch.where(live, torch.sign(value) * av_safe ** p,
                       torch.zeros_like(value))
