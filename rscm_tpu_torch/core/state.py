"""
State values, grid slices, and timeseries windows.

Mirrors ``crates/rscm-core/src/state/``:

- :class:`StateValue`: scalar-or-grid value returned from component solves.
- :class:`FourBoxSlice` / :class:`HemisphericSlice`: fixed-size regional
  value containers (``state/slices.rs``).
- :class:`ScalarWindow` / :class:`FourBoxWindow` / :class:`HemisphericWindow`:
  read access into a variable's timeseries at the current step with the
  reference's source-dependent timestep resolution (``state/windows.rs``,
  ``state/aggregating.rs``):

  * ``at_start()`` reads index N (step start),
  * ``at_end()`` reads index N+1 (written by upstream components this step),
  * ``get()`` resolves by :class:`VariableSource` — Exogenous/OwnState read
    N, UpstreamOutput reads N+1 (falling back to N at the final index),
  * unit conversion factors are applied lazily on read,
  * read-side grid aggregation wraps a finer-grid array behind a coarser
    window (``AggregatingFourBoxWindow`` etc.).

- :class:`DeviceWindow`: a host window whose reads come back as tensors
  on a device (the step-by-step executor's windows).

**Dual-mode**: the same window classes work on host numpy arrays
(float64 exactness, ``None`` returns at boundaries) and on tensors inside
the batched year loop (boundary reads clamp — the loop never reads
out-of-range indices during a normal run).  In the loop a variable the
model computes is a :class:`Trajectory` of ``(members, n_regions)`` rows,
and shared exogenous data an ``(n_steps, n_regions)`` tensor, so a row read
yields ``(members, n_regions)`` or ``(n_regions,)`` and a region read the
per-member ``(members,)`` column (or a 0-d tensor, which broadcasts).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .interpolate import InterpolationStrategy, LinearSpline, interpolate_host, interpolate_traced
from .spatial import FourBoxRegion, GridType, HemisphericRegion

__all__ = [
    "VariableSource",
    "StateValue",
    "FourBoxSlice",
    "HemisphericSlice",
    "ScalarWindow",
    "FourBoxWindow",
    "HemisphericWindow",
    "make_window",
    "DeviceWindow",
    "host_window",
    "is_traced",
    "Trajectory",
]


class Trajectory:
    """A variable's trajectory in the year loop: one ``(members, n_regions)``
    tensor per step.

    The loop replaces a row instead of writing into one ``(n_steps, members,
    n_regions)`` tensor in place, so a row that autograd saved for the
    backward is never modified, and a read touches one row instead of the
    whole trajectory.  The streaming loop releases rows no reader can reach
    any more (:meth:`release`); reading one raises.  ``matrix`` (set by
    :meth:`aggregated`) is a read-side grid aggregation applied to each row
    as it is read.
    """

    __slots__ = ("rows", "matrix")

    def __init__(self, rows, matrix=None):
        self.rows = rows
        self.matrix = matrix

    @classmethod
    def from_tensor(cls, values) -> "Trajectory":
        """The rows of an ``(n_steps, members, n_regions)`` tensor."""
        return cls(list(values.unbind(0)))

    def aggregated(self, matrix) -> "Trajectory":
        """A view (for reading) whose rows are aggregated by ``matrix``."""
        like = self.rows[-1]  # the last row is never released
        return Trajectory(
            self.rows, torch.as_tensor(matrix, dtype=like.dtype, device=like.device)
        )

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, index):
        row = self.rows[index]
        if row is None:
            raise IndexError(
                f"row {index} of a streamed trajectory was released: a component "
                "reads deeper than its input_lookback declares"
            )
        return row if self.matrix is None else row @ self.matrix

    def __setitem__(self, index, row):
        self.rows[index] = row

    def release(self, index):
        """Drop row ``index`` (the streaming loop's memory bound)."""
        self.rows[index] = None

    @property
    def shape(self):
        """``(n_steps, members, n_regions)`` as read (after ``matrix``)."""
        return (len(self.rows),) + tuple(self[-1].shape)

    def column(self, region: int) -> "_Column":
        """Region ``region`` of every row, read row by row."""
        return _Column(self, region)

    def stack(self):
        """The whole trajectory as one ``(n_steps, members, n_regions)`` tensor."""
        out = torch.stack(self.rows)
        return out if self.matrix is None else out @ self.matrix


class _Column:
    """One region of a :class:`Trajectory`, indexed by step: what the traced
    interpolation reads, without stacking the whole trajectory."""

    __slots__ = ("traj", "region")

    def __init__(self, traj, region):
        self.traj = traj
        self.region = region

    def __getitem__(self, index):
        return self.traj[index][..., self.region]

    @property
    def shape(self):
        return self.traj.shape[:-1]

    @property
    def dtype(self):
        return self.traj.rows[-1].dtype

    @property
    def device(self):
        return self.traj.rows[-1].device


def is_traced(x) -> bool:
    """True when x is a tensor or a :class:`Trajectory` (a value of the
    batched program), as opposed to a host float or numpy array."""
    return isinstance(x, (torch.Tensor, Trajectory))


def _region(row, region: int):
    """One region of a ``(..., n_regions)`` row: a tensor column, or a numpy
    scalar of a host row (as the TPU package's host windows return)."""
    return row[..., region] if is_traced(row) else row[region]


def _cols(row):
    """Per-region columns of a ``(..., n_regions)`` row."""
    return [_region(row, r) for r in range(row.shape[-1])]


class VariableSource:
    """Where a component's input comes from; decides get()'s timestep.

    Mirror of ``state/mod.rs:157-170``.
    """

    Exogenous = "Exogenous"
    UpstreamOutput = "UpstreamOutput"
    OwnState = "OwnState"


# ---------------------------------------------------------------------------
# Slices
# ---------------------------------------------------------------------------


class _Slice:
    """Fixed-length regional value container; values may be traced scalars."""

    _region_enum = None
    _size = 0
    _field_names: tuple = ()

    def __init__(self, *args, **kwargs):
        # unset regions default to NaN (reference slice semantics)
        values = [float("nan")] * self._size
        for i, v in enumerate(args):
            values[i] = v
        for name, v in kwargs.items():
            values[self._field_names.index(name)] = v
        self._values = list(values)

    @classmethod
    def uniform(cls, value):
        return cls(*([value] * cls._size))

    @classmethod
    def from_array(cls, values):
        values = list(np.asarray(values)) if isinstance(values, np.ndarray) else list(values)
        assert len(values) == cls._size
        return cls(*values)

    def _check_region(self, region) -> int:
        region = int(region)
        if not 0 <= region < self._size:
            raise ValueError(
                f"Invalid region index {region} for {type(self).__name__} "
                f"(size {self._size})"
            )
        return region

    def get(self, region) -> float:
        return self._values[self._check_region(region)]

    def set(self, region, value):
        self._values[self._check_region(region)] = value

    def as_array(self):
        """Regional values as an array: ``(..., n_regions)`` (a tensor when
        any value is one, with member axes leading)."""
        if any(is_traced(v) for v in self._values):
            ref = next(v for v in self._values if is_traced(v))
            vals = [torch.as_tensor(v, dtype=ref.dtype, device=ref.device) for v in self._values]
            shape = torch.broadcast_shapes(*(v.shape for v in vals))
            return torch.stack([v.expand(shape) for v in vals], dim=-1)
        return np.asarray([float(v) for v in self._values])

    # API-compat aliases (state.pyi)
    def to_array(self):
        return self.as_array()

    def to_list(self):
        return list(self._values)

    def to_dict(self):
        return {name: self._values[i] for i, name in enumerate(self._field_names)}

    def aggregate_global(self, grid):
        vals = self.as_array()
        if is_traced(vals):
            w = torch.tensor(np.asarray(grid.weights), dtype=vals.dtype, device=vals.device)
            return (vals * w).sum(-1)
        return float(np.dot(vals, grid.weights))

    def __getitem__(self, index):
        return self._values[index]

    def __setitem__(self, index, value):
        self._values[index] = value

    def __len__(self):
        return self._size

    def __eq__(self, other):
        if not isinstance(other, _Slice):
            return NotImplemented
        if type(self) is not type(other):
            return False
        comparisons = [a == b for a, b in zip(self._values, other._values)]
        if any(is_traced(c) for c in comparisons):
            # tensor values: the elementwise conjunction per member
            out = torch.as_tensor(comparisons[0])
            for c in comparisons[1:]:
                out = torch.logical_and(out, torch.as_tensor(c))
            return out
        return all(bool(c) for c in comparisons)

    def __repr__(self):
        fields = ", ".join(f"{n}={v!r}" for n, v in zip(self._field_names, self._values))
        return f"{type(self).__name__}({fields})"


class FourBoxSlice(_Slice):
    _region_enum = FourBoxRegion
    _size = 4
    _field_names = ("northern_ocean", "northern_land", "southern_ocean", "southern_land")

    @property
    def northern_ocean(self):
        return self._values[0]

    @northern_ocean.setter
    def northern_ocean(self, v):
        self._values[0] = v

    @property
    def northern_land(self):
        return self._values[1]

    @northern_land.setter
    def northern_land(self, v):
        self._values[1] = v

    @property
    def southern_ocean(self):
        return self._values[2]

    @southern_ocean.setter
    def southern_ocean(self, v):
        self._values[2] = v

    @property
    def southern_land(self):
        return self._values[3]

    @southern_land.setter
    def southern_land(self, v):
        self._values[3] = v


class HemisphericSlice(_Slice):
    _region_enum = HemisphericRegion
    _size = 2
    _field_names = ("northern", "southern")

    @property
    def northern(self):
        return self._values[0]

    @northern.setter
    def northern(self, v):
        self._values[0] = v

    @property
    def southern(self):
        return self._values[1]

    @southern.setter
    def southern(self, v):
        self._values[1] = v


_SLICE_FOR_SIZE = {2: HemisphericSlice, 4: FourBoxSlice}


# ---------------------------------------------------------------------------
# StateValue
# ---------------------------------------------------------------------------


class StateValue:
    """Scalar / FourBox / Hemispheric value (``state/mod.rs:62-150``)."""

    __slots__ = ("kind", "value")

    def __init__(self, kind: GridType, value):
        self.kind = kind
        self.value = value

    @staticmethod
    def scalar(value) -> "StateValue":
        return StateValue(GridType.Scalar, value)

    @staticmethod
    def four_box(slice_: FourBoxSlice) -> "StateValue":
        if not isinstance(slice_, FourBoxSlice):
            slice_ = FourBoxSlice.from_array(slice_)
        return StateValue(GridType.FourBox, slice_)

    @staticmethod
    def hemispheric(slice_: HemisphericSlice) -> "StateValue":
        if not isinstance(slice_, HemisphericSlice):
            slice_ = HemisphericSlice.from_array(slice_)
        return StateValue(GridType.Hemispheric, slice_)

    @staticmethod
    def wrap(value) -> "StateValue":
        if isinstance(value, StateValue):
            return value
        if isinstance(value, FourBoxSlice):
            return StateValue.four_box(value)
        if isinstance(value, HemisphericSlice):
            return StateValue.hemispheric(value)
        return StateValue.scalar(value)

    def is_scalar(self) -> bool:
        return self.kind is GridType.Scalar

    def is_four_box(self) -> bool:
        return self.kind is GridType.FourBox

    def is_hemispheric(self) -> bool:
        return self.kind is GridType.Hemispheric

    def as_scalar(self):
        return self.value if self.is_scalar() else None

    def as_four_box(self):
        return self.value if self.is_four_box() else None

    def as_hemispheric(self):
        return self.value if self.is_hemispheric() else None

    def to_scalar(self):
        """Unweighted mean for grids (mirror of ``state/mod.rs:30-41``)."""
        if self.is_scalar():
            return self.value
        arr = self.value.as_array()
        if is_traced(arr):
            return arr.mean(-1)
        return float(np.mean(arr))

    def as_array(self):
        """Regional values as a flat array of the grid's size."""
        if self.is_scalar():
            if is_traced(self.value):
                return self.value.unsqueeze(-1)
            return np.asarray([float(self.value)])
        return self.value.as_array()

    def __eq__(self, other):
        if not isinstance(other, StateValue):
            return NotImplemented
        if self.kind is not other.kind:
            return False
        return self.value == other.value

    def __repr__(self):
        # constructor-style, matching the reference (state/mod.rs Display):
        # StateValue.scalar(42.0) / StateValue.four_box(FourBoxSlice(...))
        constructor = {
            "Scalar": "scalar",
            "FourBox": "four_box",
            "Hemispheric": "hemispheric",
        }.get(self.kind.value, self.kind.value)
        return f"StateValue.{constructor}({self.value!r})"


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------


def _read_row(values, index):
    """values[index] along the leading time axis."""
    return values[int(index)]


class _WindowBase:
    """Shared window mechanics over a (time, space) value array.

    ``values`` is the full storage array of the variable (host numpy, a
    tensor or a :class:`Trajectory`); ``current_index`` is the step index N;
    ``factor`` the read-side unit conversion; ``source`` drives get();
    ``aggregation`` an optional (source_size -> my size) constant matrix
    implementing a read-side grid transform.
    """

    __slots__ = (
        "values",
        "current_index",
        "current_time",
        "factor",
        "source",
        "strategy",
        "time_values",
        "grid",
        "_traced",
    )

    def __init__(
        self,
        values,
        current_index,
        current_time=None,
        factor: float = 1.0,
        source: str = VariableSource.Exogenous,
        strategy: InterpolationStrategy = None,
        time_values=None,
        grid=None,
        aggregation: Optional[np.ndarray] = None,
    ):
        traced = is_traced(values)
        if aggregation is not None:
            # A trajectory aggregates the rows it is asked for; an array
            # (exogenous data, the host executor's storage) folds the
            # read-side aggregation into its view once (a small constant
            # matmul over the region axis).
            if isinstance(values, Trajectory):
                values = values.aggregated(aggregation)
            elif traced:
                values = values @ torch.as_tensor(
                    aggregation, dtype=values.dtype, device=values.device
                )
            else:
                values = values @ aggregation
        self.values = values
        self.current_index = current_index
        self.current_time = current_time
        self.factor = factor
        self.source = source
        self.strategy = strategy if strategy is not None else LinearSpline(True)
        self.time_values = time_values
        self.grid = grid
        self._traced = traced

    # -- internals ----------------------------------------------------------

    def _n(self) -> int:
        return len(self.values)

    def _row(self, index):
        row = _read_row(self.values, index)
        if self.factor != 1.0:
            row = row * self.factor
        return row

    def _row_or_none(self, index):
        """Host: None when out of range. Tensor: clamped read."""
        if self._traced:
            return self._row(min(max(int(index), 0), self._n() - 1))
        if 0 <= int(index) < self._n():
            return self._row(int(index))
        return None

    # -- common API ---------------------------------------------------------

    def time(self):
        return self.current_time

    def index(self):
        return self.current_index

    def __len__(self):
        return self._n()

    def is_empty(self):
        return self._n() == 0

    def _interp_row(self, t):
        if self._traced:
            values = self.values
            cols = [
                interpolate_traced(
                    self.time_values,
                    values.column(r) if isinstance(values, Trajectory) else values[..., r],
                    t,
                    self.strategy,
                )
                for r in range(values.shape[-1])
            ]
            row = torch.stack(cols, dim=-1)
        else:
            row = np.asarray(
                [
                    interpolate_host(self.time_values, self.values[:, r], t, self.strategy)
                    for r in range(self.values.shape[1])
                ]
            )
        if self.factor != 1.0:
            row = row * self.factor
        return row


class ScalarWindow(_WindowBase):
    """Window over a scalar variable (mirror of ``TimeseriesWindow``)."""

    def at_start(self):
        return _region(self._row(self.current_index), 0)

    def at_end(self):
        row = self._row_or_none(self.current_index + 1)
        return None if row is None else _region(row, 0)

    def get(self):
        if self.source == VariableSource.UpstreamOutput:
            end = self.at_end()
            return self.at_start() if end is None else end
        return self.at_start()

    def previous(self):
        if not self._traced and int(self.current_index) == 0:
            return None
        row = self._row_or_none(self.current_index - 1)
        return None if row is None else _region(row, 0)

    def at_offset(self, offset: int):
        row = self._row_or_none(self.current_index + offset)
        return None if row is None else _region(row, 0)

    def last_n(self, n: int):
        """Most recent n values ending at the current index (inclusive).

        Host path: asserts ``n <= index + 1``.  Tensor path: rows that
        would precede the start of the series come back as NaN (as in the
        TPU package's traced path, where the bound cannot be asserted), with
        the step axis last: ``(members..., n)``.
        """
        if self._traced:
            idx = int(self.current_index)
            current = self.values[idx][..., 0]
            rows = [
                self.values[r][..., 0] if r >= 0 else torch.full_like(current, float("nan"))
                for r in range(idx + 1 - n, idx + 1)
            ]
            out = torch.stack(rows, dim=-1)
            return out * self.factor if self.factor != 1.0 else out
        idx = int(self.current_index)
        assert n <= idx + 1, f"Cannot get {n} values when only {idx + 1} available"
        return np.asarray(self.values[idx + 1 - n : idx + 1, 0]) * self.factor

    def last_n_converted(self, n: int):
        return list(self.last_n(n))

    def interpolate(self, t):
        return _region(self._interp_row(t), 0)


class _GridWindow(_WindowBase):
    """Window over a grid variable (FourBox / Hemispheric)."""

    _slice_cls = None

    def _to_slice(self, row):
        if is_traced(row):
            return self._slice_cls.from_array(_cols(row))
        return self._slice_cls.from_array(list(row))

    # region-indexed access
    def at_start(self, region):
        return _region(self._row(self.current_index), int(region))

    def at_end(self, region):
        row = self._row_or_none(self.current_index + 1)
        return None if row is None else _region(row, int(region))

    def get(self, region):
        if self.source == VariableSource.UpstreamOutput:
            end = self.at_end(region)
            return self.at_start(region) if end is None else end
        return self.at_start(region)

    def previous(self, region):
        if not self._traced and int(self.current_index) == 0:
            return None
        row = self._row_or_none(self.current_index - 1)
        return None if row is None else _region(row, int(region))

    # all-region access
    def at_start_all(self):
        return _cols(self._row(self.current_index))

    def at_end_all(self):
        row = self._row_or_none(self.current_index + 1)
        return None if row is None else _cols(row)

    def get_all(self):
        if self.source == VariableSource.UpstreamOutput:
            end = self.at_end_all()
            return self.at_start_all() if end is None else end
        return self.at_start_all()

    def previous_all(self):
        if not self._traced and int(self.current_index) == 0:
            return None
        row = self._row_or_none(self.current_index - 1)
        return None if row is None else _cols(row)

    def at_offset_all(self, offset: int):
        row = self._row_or_none(self.current_index + offset)
        return None if row is None else _cols(row)

    # slices (typed API surface parity)
    def at_start_slice(self):
        return self._to_slice(self._row(self.current_index))

    def at_end_slice(self):
        row = self._row_or_none(self.current_index + 1)
        return None if row is None else self._to_slice(row)

    def get_slice(self):
        return self._to_slice(np.asarray(self.get_all())) if not self._traced else (
            self._to_slice(self.get_all())
        )

    # global aggregation over this window's grid
    def current_global(self):
        row = self._row(self.current_index)
        w = self.grid.weights
        if self._traced:
            return (row * torch.tensor(np.asarray(w), dtype=row.dtype, device=row.device)).sum(-1)
        return float(np.dot(row, w))

    def previous_global(self):
        row = self._row_or_none(self.current_index - 1)
        if row is None or (not self._traced and int(self.current_index) == 0):
            return None
        w = self.grid.weights
        if self._traced:
            return (row * torch.tensor(np.asarray(w), dtype=row.dtype, device=row.device)).sum(-1)
        return float(np.dot(row, w))

    def interpolate(self, t, region):
        return _region(self._interp_row(t), int(region))

    def interpolate_all(self, t):
        row = self._interp_row(t)
        return _cols(row) if is_traced(row) else list(row)


class FourBoxWindow(_GridWindow):
    _slice_cls = FourBoxSlice


class HemisphericWindow(_GridWindow):
    _slice_cls = HemisphericSlice


_WINDOW_FOR_GRID = {
    GridType.Scalar: ScalarWindow,
    GridType.FourBox: FourBoxWindow,
    GridType.Hemispheric: HemisphericWindow,
}


def make_window(
    grid_type: GridType,
    values,
    current_index,
    current_time,
    factor: float = 1.0,
    source: str = VariableSource.Exogenous,
    strategy: InterpolationStrategy = None,
    time_values=None,
    grid=None,
    aggregation=None,
):
    """Build the window matching a component's declared grid for a variable.

    When ``aggregation`` is given, ``values`` is on a finer grid and the
    window presents the aggregated (coarser) view — the read-side transform
    of ``state/aggregating.rs`` expressed as a constant matrix.
    """
    cls = _WINDOW_FOR_GRID[grid_type]
    return cls(
        values,
        current_index,
        current_time,
        factor=factor,
        source=source,
        strategy=strategy,
        time_values=time_values,
        grid=grid,
        aggregation=aggregation,
    )


# ---------------------------------------------------------------------------
# Device reads of host windows (the step-by-step executor)
# ---------------------------------------------------------------------------

#: the window methods that return values (every other attribute is the host
#: window's own)
_READS = frozenset({
    "at_start", "at_end", "get", "previous", "at_offset", "last_n", "last_n_converted",
    "interpolate", "at_start_all", "at_end_all", "get_all", "previous_all", "at_offset_all",
    "interpolate_all", "at_start_slice", "at_end_slice", "get_slice", "current_global",
    "previous_global",
})


class DeviceWindow:
    """A host window whose reads come back as tensors on a device.

    The step-by-step executor keeps every trajectory in the host collection
    and reads it through a host window, with the reference's boundary
    semantics (``None`` before the first and after the last row, asserted
    history lengths); only the values a component reads are copied to the
    device.  A variable the model computes reads with a leading member axis
    of one, as in the year loop at one member; exogenous data reads without
    one.
    """

    __slots__ = ("host", "_dtype", "_device", "_per_member")

    def __init__(self, host, dtype, device, per_member: bool):
        self.host = host
        self._dtype = dtype
        self._device = device
        self._per_member = per_member

    def _convert(self, value):
        if value is None:
            return None
        if isinstance(value, _Slice):
            return type(value)(*(self._convert(v) for v in value._values))
        if isinstance(value, (list, tuple)):
            return [self._convert(v) for v in value]
        out = torch.as_tensor(np.asarray(value, dtype=np.float64)).to(
            dtype=self._dtype, device=self._device
        )
        return out.unsqueeze(0) if self._per_member else out

    def __getattr__(self, name):
        attr = getattr(self.host, name)
        if name not in _READS:
            return attr

        def read(*args, **kwargs):
            return self._convert(attr(*args, **kwargs))

        return read

    def __len__(self):
        return len(self.host)

    def __repr__(self):
        return f"DeviceWindow({type(self.host).__name__}, {self._device})"


def host_window(window):
    """The host window behind ``window`` (``window`` itself if it is one)."""
    return window.host if isinstance(window, DeviceWindow) else window
