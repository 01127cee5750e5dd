"""
Time axis for model execution and timeseries data.

Mirrors ``crates/rscm-core/src/timeseries.rs:24-212``: values are step
*starts* (decimal years), each step has a half-open bound, bounds length is
``len + 1`` and must be strictly monotonically increasing.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TimeAxis"]


class TimeAxis:
    """Monotonic time axis with contiguous half-open step bounds."""

    __slots__ = ("_bounds",)

    def __init__(self, bounds: np.ndarray):
        bounds = np.asarray(bounds, dtype=np.float64)
        if bounds.ndim != 1 or len(bounds) < 2:
            raise ValueError("TimeAxis requires at least 2 bounds")
        if not np.all(np.diff(bounds) > 0):
            raise AssertionError("TimeAxis bounds must be strictly monotonically increasing")
        self._bounds = bounds
        self._bounds.setflags(write=False)

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_values(values) -> "TimeAxis":
        """Build from step-start values; the final step reuses the previous width.

        Mirror of ``TimeAxis::from_values`` (``timeseries.rs:66-77``).
        """
        if isinstance(values, list):
            # reference (PyO3 numpy) rejects plain lists
            raise TypeError("'list' object cannot be cast as 'ndarray'")
        values = np.asarray(values, dtype=np.float64)
        assert len(values) >= 2, "TimeAxis requires at least 2 values"
        step = values[-1] - values[-2]
        bounds = np.concatenate([values, [values[-1] + step]])
        return TimeAxis(bounds)

    @staticmethod
    def from_bounds(bounds) -> "TimeAxis":
        return TimeAxis(np.asarray(bounds, dtype=np.float64))

    # -- accessors ----------------------------------------------------------

    def values(self) -> np.ndarray:
        # a fresh owned copy (the reference returns a copy out of Rust;
        # callers mutating it must not corrupt the axis)
        return self._bounds[: len(self)].copy()

    def bounds(self) -> np.ndarray:
        return self._bounds

    def __len__(self) -> int:
        return len(self._bounds) - 1

    def len_bounds(self) -> int:
        return len(self._bounds)

    def first(self) -> float:
        return float(self._bounds[0])

    def last(self) -> float:
        return float(self._bounds[len(self)])

    def at(self, index: int):
        """Time value for a step, None past the end; negative raises
        (reference: Rust usize conversion overflows)."""
        if index < 0:
            raise OverflowError("can't convert negative int to unsigned")
        if index < len(self):
            return float(self._bounds[index])
        return None

    def at_bounds(self, index: int):
        """(start, end) bounds for a step, None past the end; negative
        raises (reference: Rust usize conversion overflows)."""
        if index < 0:
            raise OverflowError("can't convert negative int to unsigned")
        if index < len(self):
            return (float(self._bounds[index]), float(self._bounds[index + 1]))
        return None

    def get_index(self, time: float) -> int:
        idx = int(np.searchsorted(self._bounds, time, side="left"))
        if idx >= len(self._bounds) or self._bounds[idx] != time:
            raise ValueError(f"Time {time} not found in axis bounds")
        return idx

    def contains(self, value: float) -> bool:
        return bool(np.any(self.values() == value))

    def index_of(self, value: float):
        """Index of a time value within 1e-10 absolute tolerance, or None.

        Mirror of ``TimeAxis::index_of`` (``timeseries.rs:204-211``).
        """
        matches = np.nonzero(np.abs(self.values() - value) < 1e-10)[0]
        if len(matches) == 0:
            return None
        return int(matches[0])

    # -- misc ---------------------------------------------------------------

    def is_uniform(self, rtol: float = 1e-12) -> bool:
        """True when all steps have (nearly) the same width."""
        widths = np.diff(self._bounds)
        return bool(np.allclose(widths, widths[0], rtol=rtol, atol=0.0))

    def __eq__(self, other) -> bool:
        return isinstance(other, TimeAxis) and np.array_equal(self._bounds, other._bounds)

    def __hash__(self):
        return hash(self._bounds.tobytes())

    def __repr__(self) -> str:
        # the reference exposes Rust's Debug formatting; kept verbatim since
        # downstream code (and its tests) match on it
        bounds = ", ".join(repr(float(b)) for b in self._bounds)
        return (
            f"TimeAxis {{ bounds: [{bounds}], shape=[{len(self._bounds)}], "
            f"strides=[1], layout=CFcf (0xf), const ndim=1 }}"
        )

    # -- serialisation ------------------------------------------------------

    def to_dict(self) -> dict:
        return {"bounds": self._bounds.tolist()}

    @staticmethod
    def from_dict(d: dict) -> "TimeAxis":
        return TimeAxis.from_bounds(np.asarray(d["bounds"], dtype=np.float64))
