"""L-BFGS with a zoom line search, as plain torch code.

The algorithm of ``optax.lbfgs()`` in optax 0.2.6, which the JAX package's
minimisers call (``api/context.py``: ``Simulation.minimizeEnergy`` and
``Context._minimize_streamed``), with its defaults:

    scale_by_lbfgs(memory_size=10, scale_init_precond=True)
    -> scale(-1)
    -> scale_by_zoom_linesearch(max_linesearch_steps=20,
                                initial_guess_strategy="one")

with the line search's slope_rtol 1e-4, curv_rtol 0.9, increase_factor 2,
approx_dec_rtol 1e-6 and stepsize_precision 1e-5 (Nocedal and Wright,
Algorithms 3.5, 3.6 and 7.4; Hager and Zhang's approximate decrease), so
that at float64 a minimisation takes the JAX package's iterates.
``torch.optim.LBFGS`` is a different algorithm (its history, first step
and line search differ) and would not.

The vectors (positions, gradients and the memory of differences) stay on
their device; the line search's scalars (values, slopes, step sizes) are
decided on the host in IEEE double, from one download per trial point of
its value, its slope and the squared norm of its gradient. An iteration
whose line search accepts its first trial synchronises once.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
INCREASE_FACTOR = 2.0
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5

_F = np.float64


class LBFGSState(NamedTuple):
    """optax's ScaleByLBFGSState: the iteration count, the last iterate and
    gradient, and the ring of differences and their weights."""

    count: int
    params: torch.Tensor
    grad: torch.Tensor
    diff_params: tuple
    diff_grads: tuple
    weights: tuple            # 0-d tensors


class Point(NamedTuple):
    """An iterate: positions, energy and gradient (tensors), and on the host
    the energy and the gradient's squared norm."""

    x: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    value_host: float
    sumsq: float

    def rms(self) -> float:
        """sqrt(mean(grad^2)): the minimisers' stopping measure."""
        with np.errstate(all="ignore"):
            return float(np.sqrt(_F(self.sumsq) / _F(self.grad.numel())))


def _vdot(a, b):
    return (a * b).sum()


def init(x) -> LBFGSState:
    """The state before the first iteration (optax's ``init``)."""
    zero = torch.zeros_like(x)
    w0 = x.new_zeros(())
    return LBFGSState(0, zero, zero, (zero,) * MEMORY_SIZE,
                      (zero,) * MEMORY_SIZE, (w0,) * MEMORY_SIZE)


def point(x, value_and_grad: Callable) -> Point:
    """Evaluate ``value_and_grad`` at ``x``: one download."""
    value, grad = value_and_grad(x)
    v, s = torch.stack([value, _vdot(grad, grad)]).tolist()
    return Point(x, value, grad, v, s)


def direction(state: LBFGSState, x, grad):
    """The L-BFGS descent direction -P_k g_k and the next state (optax's
    ``scale_by_lbfgs`` update, then ``scale(-1)``); on the device, no
    synchronisation."""
    m = len(state.weights)
    count = state.count
    mem = count % m
    prev = (count - 1) % m
    if count > 0:
        dp = x - state.params
        dg = grad - state.grad
        vd = _vdot(dg, dp)
        weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
        den = _vdot(dg, dg)
        scale = torch.where(den > 0.0, vd / den, torch.ones_like(vd))
    else:
        dp = dg = torch.zeros_like(x)
        weight = x.new_zeros(())
        norm = torch.sqrt(_vdot(grad, grad))
        scale = torch.minimum(torch.ones_like(norm), 1.0 / norm)
    diff_params = state.diff_params[:prev] + (dp,) + \
        state.diff_params[prev + 1:]
    diff_grads = state.diff_grads[:prev] + (dg,) + \
        state.diff_grads[prev + 1:]
    weights = state.weights[:prev] + (weight,) + state.weights[prev + 1:]

    order = [(mem + i) % m for i in range(m)]
    vec = grad
    alphas = {}
    for i in reversed(order):
        alphas[i] = weights[i] * _vdot(diff_params[i], vec)
        vec = vec + (-alphas[i]) * diff_grads[i]
    vec = scale * vec
    for i in order:
        beta = weights[i] * _vdot(diff_grads[i], vec)
        vec = vec + (alphas[i] - beta) * diff_params[i]
    new = LBFGSState(count + 1, x, grad, diff_params, diff_grads, weights)
    return -1.0 * vec, new


def _maximum(a, b):
    return np.maximum(_F(a), _F(b))


def _minimum(a, b):
    return np.minimum(_F(a), _F(b))


def _nan_to_inf(e):
    return _F(math.inf) if np.isnan(e) else e


def _decrease_error(stepsize, value_step, slope_step, value_init,
                    slope_init):
    dec = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta = value_step - value_init - APPROX_DEC_RTOL * np.abs(value_init)
    approx = _maximum(approx, delta)
    dec = _minimum(approx, dec)
    return _nan_to_inf(_maximum(dec, 0.0))


def _curvature_error(slope_step, slope_init):
    return _nan_to_inf(_maximum(
        np.abs(slope_step) - CURV_RTOL * np.abs(slope_init), 0.0))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v1 = fb - fa - C * db
    v2 = fc - fa - C * dc
    A = (dc * dc * v1 + -(db * db) * v2) / denom
    B = (-(dc * (dc * dc)) * v1 + db * (db * db) * v2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


class _Trial(NamedTuple):
    stepsize: np.float64
    point: Point
    slope: np.float64


def zoom_linesearch(start: Point, updates,
                    value_and_grad: Callable) -> _Trial:
    """optax's zoom line search from ``start`` along ``updates``, with
    ``initial_guess_strategy="one"``, no maximal step size and tol 0.
    Returns the accepted trial: its step size, its point and its slope."""
    with np.errstate(all="ignore"):
        return _zoom(start, updates, value_and_grad)


def _zoom(start, updates, value_and_grad):
    x0 = start.x
    slope_init_t = _vdot(updates, start.grad)
    slope_init = None
    value_init = _F(start.value_host)

    def trial(stepsize):
        nonlocal slope_init
        x = x0 + float(stepsize) * updates
        value, grad = value_and_grad(x)
        parts = [value, _vdot(grad, updates), _vdot(grad, grad)]
        if slope_init is None:
            parts.append(slope_init_t)
        got = torch.stack(parts).tolist()
        if slope_init is None:
            slope_init = _F(got[3])
        return _Trial(_F(stepsize), Point(x, value, grad, got[0], got[2]),
                      _F(got[1]))

    cur = _Trial(_F(0.0), start, None)   # the last trial (stepsize 0)
    count = 0
    interval_found = done = failed = False
    decrease_error = _F(math.inf)
    low = high = cubic_ref = None        # trials bounding the interval
    safe = None                          # best sufficient decrease so far

    while not (done or failed):
        if not interval_found:
            # Algorithm 3.5 of Nocedal and Wright: search an interval
            prev = cur
            new_step = _F(1.0) if count == 0 else INCREASE_FACTOR * \
                prev.stepsize
            new = trial(new_step)
            if prev.slope is None:          # the start: slope_init
                prev = prev._replace(slope=slope_init)
            decrease_error = _decrease_error(
                new.stepsize, _F(new.point.value_host), new.slope,
                value_init, slope_init)
            curvature_error = _curvature_error(new.slope, slope_init)
            new_error = _maximum(decrease_error, curvature_error)
            if decrease_error <= 0.0:
                safe = new
            set_high = (decrease_error > 0.0) | (
                (_F(new.point.value_host) >= _F(prev.point.value_host))
                & (count > 0))
            set_low = (new.slope >= 0.0) & (not set_high)
            if set_low:
                low, high = new, prev
            else:
                low, high = prev, new
            cubic_ref = low
            interval_found = bool(set_high | set_low | (new_error <= 0.0))
            done = bool(new_error <= 0.0)
            failed = (count + 1 >= MAX_LINESEARCH_STEPS) and not done
            cur = new
        else:
            # Algorithm 3.6: zoom into [low, high]
            lo_s, hi_s = low.stepsize, high.stepsize
            delta = np.abs(hi_s - lo_s)
            left, right = _minimum(hi_s, lo_s), _maximum(hi_s, lo_s)
            cubic_chk = 0.2 * delta
            quad_chk = 0.1 * delta
            too_small = delta <= STEPSIZE_PRECISION
            v_lo, v_hi = _F(low.point.value_host), _F(high.point.value_host)
            m_cubic = _cubicmin(lo_s, v_lo, low.slope, hi_s, v_hi,
                                cubic_ref.stepsize,
                                _F(cubic_ref.point.value_host))
            use_cubic = (m_cubic > left + cubic_chk) & (
                m_cubic < right - cubic_chk)
            m_quad = _quadmin(lo_s, v_lo, low.slope, hi_s, v_hi)
            use_quad = (not use_cubic) & (m_quad > left + quad_chk) & (
                m_quad < right - quad_chk)
            if use_cubic:
                middle = m_cubic
            elif use_quad:
                middle = m_quad
            else:
                middle = (lo_s + hi_s) / 2.0
            mid = trial(middle)
            v_mid = _F(mid.point.value_host)
            decrease_error = _decrease_error(mid.stepsize, v_mid, mid.slope,
                                             value_init, slope_init)
            curvature_error = _curvature_error(mid.slope, slope_init)
            new_error = _maximum(decrease_error, curvature_error)
            safe_value = (value_init if safe is None
                          else _F(safe.point.value_host))
            if (decrease_error <= 0.0) & (v_mid < safe_value):
                safe = mid
            done = bool(new_error <= 0.0)
            set_high_to_mid = (decrease_error > 0.0) | (v_mid >= v_lo)
            set_high_to_low = (mid.slope * (hi_s - lo_s) >= 0.0) & (
                not set_high_to_mid)
            old_low, old_high = low, high
            if set_high_to_mid:
                high = mid
            if set_high_to_low:
                high = old_low
            if not set_high_to_mid:
                low = mid
            cubic_ref = (old_high if (set_high_to_mid or set_high_to_low)
                         else old_low)
            presumably = (count + 1 >= MAX_LINESEARCH_STEPS) or (
                too_small and safe is not None)
            failed = bool(presumably and not done)
            cur = mid
        count += 1
        if failed:
            # take the safe step, if one gave a sufficient decrease (or if
            # the last trial left the function's domain)
            if safe is not None or np.isinf(decrease_error):
                cur = safe if safe is not None else _Trial(
                    _F(0.0), start, slope_init)
    return cur


def minimize_step(state: LBFGSState, at: Point, value_and_grad: Callable):
    """One iteration of ``optax.lbfgs()``: direction, line search, step.
    Returns (the new point, the new state)."""
    updates, state = direction(state, at.x, at.grad)
    return zoom_linesearch(at, updates, value_and_grad).point, state
