"""
Reference-ergonomics window classes for the compat surface.

The port's windows (``rscm_tpu_torch.core.state``) serve both executors
and favour None-returning boundary reads (the reference's *internal*
window semantics). The reference's *PyO3-exposed* window objects
(``TimeseriesWindow`` etc., state.pyi) have stricter user-facing
ergonomics: validating constructors, ``previous`` as a property that
raises before index 0, ``at_offset`` that raises out-of-bounds, clamping
``last_n``, and slice-returning ``*_all`` accessors. These subclasses add
exactly that surface.

They take numpy arrays or tensors on any device, and keep one float64
host copy of the values: the reference's windows are host copies of the
history and answer with Python floats, numpy arrays and slices, so every
read after the copy is a host read, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from rscm_tpu_torch.core.state import (
    FourBoxSlice,
    FourBoxWindow,
    HemisphericSlice,
    HemisphericWindow,
    ScalarWindow,
)

__all__ = [
    "TimeseriesWindow",
    "FourBoxTimeseriesWindow",
    "HemisphericTimeseriesWindow",
]


def _normalize(values, current_index, n_regions):
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu()
    values = np.asarray(values, dtype=np.float64)
    if values.ndim == 1:
        values = values[:, None]
    if values.shape[1] != n_regions:
        raise ValueError(
            f"expected {n_regions} regional column(s), got {values.shape[1]}"
        )
    if not 0 <= int(current_index) < len(values):
        raise ValueError(
            f"current_index {current_index} out of bounds for length {len(values)}"
        )
    return values


class TimeseriesWindow(ScalarWindow):
    """Scalar window with the reference's user-facing ergonomics."""

    def __init__(self, values, current_index, current_time=None, **kwargs):
        values = _normalize(values, current_index, 1)
        super().__init__(values, current_index, current_time, **kwargs)

    @property
    def previous(self):
        idx = int(self.current_index)
        if idx == 0:
            raise ValueError("No previous value before index 0")
        return float(self.values[idx - 1, 0])

    def at_offset(self, offset: int):
        idx = int(self.current_index) + int(offset)
        if not 0 <= idx < len(self.values):
            raise ValueError(
                f"offset {offset} out of bounds (index {idx} for "
                f"length {len(self.values)})"
            )
        return float(self.values[idx, 0])

    def last_n(self, n: int):
        idx = int(self.current_index)
        start = max(0, idx + 1 - int(n))
        return np.asarray(self.values[start : idx + 1, 0])

    def to_array(self):
        return np.asarray(self.values[:, 0])

    def __len__(self):
        return len(self.values)

    def __repr__(self):
        return (
            f"TimeseriesWindow(len={len(self.values)}, "
            f"current_index={int(self.current_index)})"
        )


class _GridCompatMixin:
    _n_regions = 0
    _slice_type = None

    def _check_region(self, region):
        region = int(region)
        if not 0 <= region < self._n_regions:
            raise ValueError(
                f"Invalid region index {region} (grid has "
                f"{self._n_regions} regions)"
            )
        return region

    @property
    def previous(self):
        idx = int(self.current_index)
        if idx == 0:
            raise ValueError("No previous value before index 0")
        return self._slice_type.from_array(np.asarray(self.values[idx - 1]))

    def region(self, index: int) -> TimeseriesWindow:
        index = self._check_region(index)
        return TimeseriesWindow(
            np.asarray(self.values[:, index]), int(self.current_index)
        )

    def at_start(self, region):
        return super().at_start(self._check_region(region))

    def at_end(self, region):
        return super().at_end(self._check_region(region))

    def at_start_all(self):
        return self._slice_type.from_array(np.asarray(super().at_start_all()))

    def at_end_all(self):
        row = super().at_end_all()
        return None if row is None else self._slice_type.from_array(np.asarray(row))

    def __len__(self):
        return len(self.values)

    def __repr__(self):
        return (
            f"{type(self).__name__}(len={len(self.values)}, "
            f"current_index={int(self.current_index)})"
        )


class FourBoxTimeseriesWindow(_GridCompatMixin, FourBoxWindow):
    """FourBox window with the reference's user-facing ergonomics."""

    _n_regions = 4
    _slice_type = FourBoxSlice

    def __init__(self, values, current_index, current_time=None, **kwargs):
        values = _normalize(values, current_index, 4)
        super().__init__(values, current_index, current_time, **kwargs)


class HemisphericTimeseriesWindow(_GridCompatMixin, HemisphericWindow):
    """Hemispheric window with the reference's user-facing ergonomics."""

    _n_regions = 2
    _slice_type = HemisphericSlice

    def __init__(self, values, current_index, current_time=None, **kwargs):
        values = _normalize(values, current_index, 2)
        super().__init__(values, current_index, current_time, **kwargs)
