"""
1-D interpolation strategies.

Semantics mirror the reference implementation
(``crates/rscm-core/src/interpolate/``): three strategies — linear spline,
next-value, previous-value — each with an optional-extrapolation flag, built
on a shared ``find_segment`` routine with "on boundary" fast paths using an
``is_close`` comparison (rel_tol 1e-9, like Rust's ``is_close`` crate and
Python's ``math.isclose``).

Two implementations are provided:

- **Host** (:func:`interpolate_host`): exact float64 numpy/scalar code used at
  build time (re-gridding exogenous data) and in the eager execution path.
- **Tensor** (:func:`interpolate_traced`): torch code with identical
  arithmetic over a batch of members.  Out-of-range behaviour when
  extrapolation is disabled cannot raise per member; the tensor version
  clamps per the strategy's extrapolation formula (callers validate ranges
  on the host when bounds are static).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
import numpy as np

from .errors import ExtrapolationError

__all__ = [
    "InterpolationKind",
    "InterpolationStrategy",
    "LinearSpline",
    "Next",
    "Previous",
    "Interp1d",
    "interpolate_host",
    "interpolate_traced",
]


class InterpolationKind(Enum):
    Linear = "Linear"
    Next = "Next"
    Previous = "Previous"


@dataclass(frozen=True)
class InterpolationStrategy:
    """An interpolation strategy: kind + extrapolation flag.

    Serialises as the bare kind name (matching the reference's serde format,
    ``timeseries.rs:922`` — ``"interpolation_strategy":"Linear"``).
    """

    kind: InterpolationKind
    extrapolate: bool = True

    def to_json(self) -> str:
        # kind only — the reference's serde impl drops the extrapolate
        # flag on save and restores True on load
        # (interpolate/strategies/mod.rs:156-185); mirrored deliberately
        # so round-tripped collections behave identically
        return self.kind.value

    @staticmethod
    def from_json(name: str) -> "InterpolationStrategy":
        return InterpolationStrategy(InterpolationKind(name), True)


def LinearSpline(extrapolate: bool = False) -> InterpolationStrategy:
    return InterpolationStrategy(InterpolationKind.Linear, extrapolate)


def Next(extrapolate: bool = False) -> InterpolationStrategy:
    return InterpolationStrategy(InterpolationKind.Next, extrapolate)


def Previous(extrapolate: bool = False) -> InterpolationStrategy:
    return InterpolationStrategy(InterpolationKind.Previous, extrapolate)


# ---------------------------------------------------------------------------
# find_segment — shared segment classification (interpolate/strategies/mod.rs:24-82)
# ---------------------------------------------------------------------------

_IN_SEGMENT = 0
_EXTRAP_BACKWARD = 1
_EXTRAP_FORWARD = 2
_ON_BOUNDARY = 3


def _find_segment_index(target: float, time_bounds: np.ndarray) -> int:
    """Binary-search insertion semantics matching Rust ``binary_search_by``.

    Returns the found index on an exact match, else the insertion point.
    """
    idx = int(np.searchsorted(time_bounds, target, side="left"))
    # searchsorted 'left' returns the first index where bounds[i] >= target,
    # which equals Rust's Err(insertion) — and on exact match equals a valid
    # Ok(index) (any matching index is acceptable; values are strictly
    # monotonic so the match is unique).
    return idx


def _find_segment(target: float, time_bounds: np.ndarray, extrapolate: bool):
    end_segment_idx = _find_segment_index(target, time_bounds)
    n = len(time_bounds)

    needs_extrap_forward = end_segment_idx == n
    needs_extrap_backward = (not needs_extrap_forward) and end_segment_idx == 0

    if not needs_extrap_forward and math.isclose(
        float(time_bounds[end_segment_idx]), float(target), rel_tol=1e-9
    ):
        return _ON_BOUNDARY, end_segment_idx

    needs_extrap = needs_extrap_backward or needs_extrap_forward
    if needs_extrap and not extrapolate:
        if needs_extrap_backward:
            raise ExtrapolationError(target, "start of", float(time_bounds[0]))
        raise ExtrapolationError(target, "end of", float(time_bounds[-1]))

    if needs_extrap_backward:
        return _EXTRAP_BACKWARD, 0
    if needs_extrap_forward:
        return _EXTRAP_FORWARD, n
    return _IN_SEGMENT, end_segment_idx


# ---------------------------------------------------------------------------
# Host (exact float64) implementation
# ---------------------------------------------------------------------------


def interpolate_host(
    time: np.ndarray,
    y: np.ndarray,
    target: float,
    strategy: InterpolationStrategy,
) -> float:
    """Interpolate ``y(time)`` at ``target`` on the host (float64).

    ``time`` may have the same length as ``y`` or one more (bounds); the
    linear strategy restricts segment search to ``time[:len(time)-1]``
    (matching ``linear_spline.rs:34-48``).  Deliberate reference parity:
    with values-length ``time`` the reference treats the LAST data point
    as forward extrapolation too — ``at_time(t_last)`` raises under
    ``LinearSpline(False)`` and reproduces ``y[-1]`` only up to float
    round-off under ``LinearSpline(True)`` (its own tests pass bounds-
    style arrays; ``at_time_all`` passes ``values()``).  Do not "fix"
    this here: the reference suite pins the behaviour.
    """
    time = np.asarray(time, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)

    if strategy.kind is InterpolationKind.Linear:
        seg, end_idx = _find_segment(target, time[: len(time) - 1], strategy.extrapolate)
        end_idx = min(end_idx, len(y) - 1)
        if seg == _ON_BOUNDARY:
            return float(y[end_idx])
        if seg == _EXTRAP_BACKWARD:
            t1, t2, y1, y2 = time[0], time[1], y[0], y[1]
        elif seg == _EXTRAP_FORWARD:
            t1, t2 = time[len(y) - 2], time[len(y) - 1]
            y1, y2 = y[len(y) - 2], y[len(y) - 1]
        else:
            t1, t2 = time[end_idx - 1], time[end_idx]
            y1, y2 = y[end_idx - 1], y[end_idx]
        m = (y2 - y1) / (t2 - t1)
        return float(m * (target - t1) + y1)

    if strategy.kind is InterpolationKind.Next:
        seg, end_idx = _find_segment(target, time, strategy.extrapolate)
        end_idx = min(end_idx, len(y) - 1)
        if seg == _ON_BOUNDARY:
            return float(y[end_idx])
        if seg == _EXTRAP_BACKWARD:
            return float(y[0])
        if seg == _EXTRAP_FORWARD:
            return float(y[-1])
        return float(y[end_idx])

    if strategy.kind is InterpolationKind.Previous:
        seg, end_idx = _find_segment(target, time, strategy.extrapolate)
        if seg == _ON_BOUNDARY:
            return float(y[min(end_idx, len(y) - 1)])
        if seg == _EXTRAP_BACKWARD:
            return float(y[0])
        if seg == _EXTRAP_FORWARD:
            return float(y[-1])
        return float(y[end_idx - 1])

    raise ValueError(f"Unknown interpolation kind: {strategy.kind}")


class Interp1d:
    """Host interpolator over a fixed (time, y) pair.

    Mirror of ``Interp1d`` (``crates/rscm-core/src/interpolate/mod.rs:26-59``).
    """

    def __init__(self, time, y, strategy: InterpolationStrategy):
        self.time = np.asarray(time, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        self.strategy = strategy

    def with_strategy(self, strategy: InterpolationStrategy) -> "Interp1d":
        self.strategy = strategy
        return self

    def interpolate(self, target: float) -> float:
        return interpolate_host(self.time, self.y, target, self.strategy)


# ---------------------------------------------------------------------------
# Tensor (branch-free) implementation
# ---------------------------------------------------------------------------


def interpolate_traced(time, y, target, strategy: InterpolationStrategy):
    """Branch-free interpolation on tensors.

    Arithmetic matches :func:`interpolate_host` (same segment endpoints, same
    ``m*(t-t1)+y1`` form for linear) so host and tensor paths agree to the
    last ulp in the same dtype.  ``y`` is ``(n_times, members...)``; the
    target is a scalar.

    Out-of-domain targets follow the extrapolation formulas regardless of the
    strategy's ``extrapolate`` flag (a batched program cannot raise per
    member); callers with static targets should validate on the host first.
    """
    import torch

    time = torch.as_tensor(time, dtype=y.dtype, device=y.device)
    target = torch.as_tensor(target, dtype=y.dtype, device=y.device)
    n = y.shape[0]

    def isclose(a, b):
        return (a - b).abs() <= 1e-9 * torch.maximum(a.abs(), b.abs())

    def at(i):
        return y[int(i)]

    if strategy.kind is InterpolationKind.Linear:
        bounds = time[: time.shape[0] - 1]
        idx = int(torch.searchsorted(bounds, target.reshape(1), side="left")[0])
        on_boundary = idx < bounds.shape[0] and bool(
            isclose(bounds[min(idx, bounds.shape[0] - 1)], target)
        )
        # Segment endpoints (clamped indices reproduce the backward/forward
        # extrapolation endpoint selection).
        lo = min(max(idx - 1, 0), n - 2)
        hi = lo + 1
        t1, t2 = time[lo], time[hi]
        y1, y2 = at(lo), at(hi)
        m = (y2 - y1) / (t2 - t1)
        lin = m * (target - t1) + y1
        return at(min(idx, n - 1)) if on_boundary else lin

    idx = int(torch.searchsorted(time, target.reshape(1), side="left")[0])
    on_boundary = idx < time.shape[0] and bool(
        isclose(time[min(idx, time.shape[0] - 1)], target)
    )
    if strategy.kind is InterpolationKind.Next:
        return at(min(max(idx, 0), n - 1))
    if strategy.kind is InterpolationKind.Previous:
        if on_boundary:
            return at(min(idx, n - 1))
        return at(min(max(idx - 1, 0), n - 1))
    raise ValueError(f"Unknown interpolation kind: {strategy.kind}")
