"""
Spatially-resolved timeseries and the name-keyed collection of model state.

Mirrors ``crates/rscm-core/src/timeseries.rs`` (``GridTimeseries``) and
``timeseries_collection.rs`` (``TimeseriesCollection``):

- values are a float64 array of shape ``(time, space)``, NaN-filled when
  unset, with a ``latest`` valid-index tracker (a timestep is valid when all
  regions are non-NaN);
- per-region temporal interpolation via the strategies in
  :mod:`rscm_tpu_torch.core.interpolate`;
- grid transforms and re-gridding (``interpolate_into``) onto new time axes;
- the collection keeps items sorted by name for stable serialisation and
  grid-checks all setters.

These are *host-side* (numpy, float64) containers: the build phase uses them
for exogenous data preparation and the compiled program writes results back
into them.  On-device state is plain arrays managed by the model program —
see :mod:`rscm_tpu_torch.core.model.program`.
"""

from __future__ import annotations

import math
from enum import Enum
from typing import Optional

import numpy as np

from .errors import GridOutputMismatchError
from .interpolate import Interp1d, InterpolationStrategy, LinearSpline
from .spatial import GridType, ScalarGrid, ScalarRegion, SpatialGrid
from .time_axis import TimeAxis

__all__ = [
    "GridTimeseries",
    "Timeseries",
    "VariableType",
    "TimeseriesItem",
    "TimeseriesCollection",
]


class VariableType(Enum):
    Exogenous = "Exogenous"
    Endogenous = "Endogenous"


class GridTimeseries:
    """A timeseries on a spatial grid: values shape ``(n_time, n_regions)``."""

    __slots__ = ("grid", "_values", "_time_axis", "units", "_latest", "interpolation_strategy")

    def __init__(
        self,
        values,
        time_axis: TimeAxis,
        grid: SpatialGrid,
        units: str = "",
        interpolation_strategy: InterpolationStrategy = None,
    ):
        values = np.array(values, dtype=np.float64)
        if values.ndim == 1:
            values = values[:, None]
        if values.shape[0] != len(time_axis):
            raise ValueError(
                f"Time dimension ({values.shape[0]}) must match time axis "
                f"length ({len(time_axis)})"
            )
        if values.shape[1] != grid.size():
            raise ValueError(
                f"Space dimension ({values.shape[1]}) must match grid size "
                f"({grid.size()})"
            )
        self.grid = grid
        self._values = values
        self._time_axis = time_axis
        self.units = units
        self.interpolation_strategy = (
            interpolation_strategy if interpolation_strategy is not None else LinearSpline(True)
        )
        self._recompute_latest()

    def _recompute_latest(self):
        valid = ~np.any(np.isnan(self._values), axis=1)
        idx = np.nonzero(valid)[0]
        # Mirror of timeseries.rs:315-321: `latest` is the *last* index whose
        # row is fully valid (0 when none are).
        self._latest = int(idx[-1]) if len(idx) else 0

    # -- constructors -------------------------------------------------------

    @staticmethod
    def new_empty(
        time_axis: TimeAxis,
        grid: SpatialGrid,
        units: str = "",
        interpolation_strategy: InterpolationStrategy = None,
    ) -> "GridTimeseries":
        values = np.full((len(time_axis), grid.size()), np.nan)
        return GridTimeseries(values, time_axis, grid, units, interpolation_strategy)

    # -- basic accessors ----------------------------------------------------

    def __len__(self) -> int:
        return self._values.shape[0]

    def time_axis(self) -> TimeAxis:
        return self._time_axis

    @property
    def latest(self) -> int:
        return self._latest

    def values(self) -> np.ndarray:
        return self._values

    def at_index(self, time_index: int, region_index: int):
        if 0 <= time_index < len(self) and 0 <= region_index < self.grid.size():
            return float(self._values[time_index, region_index])
        return None

    def set_index(self, time_index: int, region_index: int, value: float):
        # latest only ever advances on a fully-valid row; a NaN overwrite
        # of the current latest row deliberately does NOT lower it —
        # reference parity (timeseries.rs:388-394 guards identically)
        self._values[time_index, region_index] = value
        if time_index >= self._latest and not math.isnan(value):
            if not np.any(np.isnan(self._values[time_index])):
                self._latest = time_index

    def set_all(self, time_index: int, values):
        values = np.asarray(values, dtype=np.float64)
        assert values.shape == (self.grid.size(),), (
            f"Values length ({values.shape}) must match grid size ({self.grid.size()})"
        )
        self._values[time_index, :] = values
        if time_index >= self._latest and not np.any(np.isnan(values)):
            self._latest = time_index

    def at_time_index(self, time_index: int):
        if 0 <= time_index < len(self):
            return list(self._values[time_index])
        return None

    def latest_values(self) -> list:
        return list(self._values[self._latest])

    # -- interpolation ------------------------------------------------------

    def at_time_all(self, time: float) -> list:
        tvals = self._time_axis.values()
        return [
            Interp1d(tvals, self._values[:, r], self.interpolation_strategy).interpolate(time)
            for r in range(self.grid.size())
        ]

    def interpolate_into(self, new_time_axis: TimeAxis) -> "GridTimeseries":
        tvals = self._time_axis.values()
        new_vals = np.empty((len(new_time_axis), self.grid.size()))
        for r in range(self.grid.size()):
            interp = Interp1d(tvals, self._values[:, r], self.interpolation_strategy)
            for t_idx, t in enumerate(new_time_axis.values()):
                new_vals[t_idx, r] = interp.interpolate(float(t))
        return GridTimeseries(
            new_vals, new_time_axis, self.grid, self.units, self.interpolation_strategy
        )

    # -- aggregation / transforms ------------------------------------------

    def latest_global(self) -> float:
        return self.grid.aggregate_global(self.latest_values())

    def aggregate_global(self) -> "GridTimeseries":
        global_vals = self._values @ self.grid.weights
        return GridTimeseries(
            global_vals[:, None],
            self._time_axis,
            ScalarGrid(),
            self.units,
            self.interpolation_strategy,
        )

    def transform_to(self, target_grid: SpatialGrid) -> "GridTimeseries":
        m = self.grid.transform_matrix(target_grid)
        return GridTimeseries(
            self._values @ m,
            self._time_axis,
            target_grid,
            self.units,
            self.interpolation_strategy,
        )

    def region(self, region_index: int) -> "GridTimeseries":
        assert 0 <= region_index < self.grid.size(), "Region index out of bounds"
        return GridTimeseries(
            self._values[:, region_index : region_index + 1],
            self._time_axis,
            ScalarGrid(),
            self.units,
            self.interpolation_strategy,
        )

    def region_by_name(self, name: str):
        names = self.grid.region_names()
        if name not in names:
            return None
        return self.region(names.index(name))

    def with_interpolation_strategy(self, strategy: InterpolationStrategy) -> "GridTimeseries":
        self.interpolation_strategy = strategy
        return self

    # -- scalar conveniences (ScalarGrid only) ------------------------------

    @staticmethod
    def from_values(values, time) -> "Timeseries":
        """Scalar timeseries from 1-D values + times (Linear, extrapolating)."""
        values = np.asarray(values, dtype=np.float64)
        return GridTimeseries(
            values[:, None],
            TimeAxis.from_values(np.asarray(time, dtype=np.float64)),
            ScalarGrid(),
            "",
            LinearSpline(True),
        )

    @staticmethod
    def new_empty_scalar(
        time_axis: TimeAxis, units: str = "", interpolation_strategy=None
    ) -> "Timeseries":
        return GridTimeseries.new_empty(time_axis, ScalarGrid(), units, interpolation_strategy)

    def at(self, time_index: int, region=ScalarRegion.Global):
        return self.at_index(time_index, int(region))

    def set(self, time_index: int, region, value: float = None):
        # Accept both set(idx, value) for scalar and set(idx, region, value).
        if value is None:
            value = region
            region = ScalarRegion.Global
        self.set_index(time_index, int(region), float(value))

    def at_scalar(self, index: int):
        return self.at_index(index, 0)

    def set_scalar(self, time_index: int, value: float):
        self.set_index(time_index, 0, value)

    def latest_value(self):
        return self.at_index(self._latest, 0)

    def at_time(self, time: float, region=ScalarRegion.Global) -> float:
        return self.at_time_all(time)[int(region)]

    def set_from_slice(self, time_index: int, slice_values):
        """Set all regions at a time index from a slice object or sequence."""
        arr = getattr(slice_values, "as_array", lambda: slice_values)()
        self.set_all(time_index, np.asarray(arr, dtype=np.float64))

    # -- misc ---------------------------------------------------------------

    def copy(self) -> "GridTimeseries":
        return GridTimeseries(
            self._values.copy(),
            self._time_axis,
            self.grid,
            self.units,
            self.interpolation_strategy,
        )

    def __repr__(self):
        return (
            f"GridTimeseries(grid={self.grid.grid_name()}, n={len(self)}, "
            f"units={self.units!r}, latest={self._latest})"
        )

    # -- serialisation ------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "values": self._values.tolist(),
            "time_axis": self._time_axis.to_dict(),
            "units": self.units,
            "latest": self._latest,
            "interpolation_strategy": self.interpolation_strategy.to_json(),
            "grid": {
                "type": self.grid.grid_name(),
                "weights": self.grid.weights.tolist(),
            },
        }

    @staticmethod
    def from_dict(d: dict) -> "GridTimeseries":
        from .spatial import grid_for_type

        gtype = GridType(d["grid"]["type"])
        weights = d["grid"]["weights"] if gtype is not GridType.Scalar else None
        ts = GridTimeseries(
            np.asarray(d["values"], dtype=np.float64),
            TimeAxis.from_dict(d["time_axis"]),
            grid_for_type(gtype, weights),
            d.get("units", ""),
            InterpolationStrategy.from_json(d.get("interpolation_strategy", "Linear")),
        )
        if "latest" in d:
            # honor the stored tracker (the reference round-trips the
            # `latest` field verbatim, timeseries.rs:260-273); recomputing
            # from NaN rows can shift it when the pointer deliberately
            # differs from the last fully-valid row
            ts._latest = int(d["latest"])
        return ts


# Scalar timeseries is just a GridTimeseries on a ScalarGrid
# (mirror of the type alias at timeseries.rs:860).
class _ScalarTimeseriesView(GridTimeseries):
    """Scalar timeseries clone whose ``values()`` is the flat 1-D series
    (the reference's scalar ``Timeseries`` shape, returned by
    ``TimeseriesCollection.get_timeseries_by_name``)."""

    __slots__ = ()

    def values(self) -> np.ndarray:
        return self._values[:, 0]


Timeseries = GridTimeseries


class TimeseriesItem:
    """Named entry in a collection: data + variable type."""

    __slots__ = ("data", "name", "variable_type")

    def __init__(self, data: GridTimeseries, name: str, variable_type: VariableType):
        self.data = data
        self.name = name
        self.variable_type = variable_type

    @property
    def grid_type(self) -> GridType:
        return self.data.grid.grid_type

    def __repr__(self):
        return f"TimeseriesItem({self.name!r}, {self.variable_type.value}, {self.data!r})"


class TimeseriesCollection:
    """Name-keyed store of all model state, sorted by name.

    Mirror of ``timeseries_collection.rs:318-462`` including grid-checked
    setters and the sorted-by-name invariant.
    """

    def __init__(self):
        self._items: list[TimeseriesItem] = []
        self._index: dict[str, int] = {}

    def _add(self, name: str, data: GridTimeseries, variable_type: VariableType):
        if name in self._index:
            raise ValueError(f"timeseries {name} already exists")
        # bisect keeps the by-name ordering with one O(n) insert (a full
        # re-sort per item made bulk building O(n^2 log n))
        import bisect

        i = bisect.bisect([item.name for item in self._items], name)
        self._items.insert(i, TimeseriesItem(data, name, variable_type))
        self._index = {item.name: k for k, item in enumerate(self._items)}

    def add_timeseries(
        self, name: str, timeseries: GridTimeseries,
        variable_type: VariableType = VariableType.Exogenous,
    ):
        if timeseries.grid.size() != 1:
            raise GridOutputMismatchError(name, "Scalar", timeseries.grid.grid_name())
        # store a copy: later mutation of the caller's object must not leak
        # into the collection (reference clones on add)
        self._add(name, timeseries.copy(), variable_type)

    def add_four_box_timeseries(
        self, name: str, timeseries: GridTimeseries,
        variable_type: VariableType = VariableType.Exogenous,
    ):
        if timeseries.grid.size() != 4:
            raise GridOutputMismatchError(name, "FourBox", timeseries.grid.grid_name())
        # store a copy: later mutation of the caller's object must not leak
        # into the collection (reference clones on add)
        self._add(name, timeseries.copy(), variable_type)

    def add_hemispheric_timeseries(
        self, name: str, timeseries: GridTimeseries,
        variable_type: VariableType = VariableType.Exogenous,
    ):
        if timeseries.grid.size() != 2:
            raise GridOutputMismatchError(name, "Hemispheric", timeseries.grid.grid_name())
        # store a copy: later mutation of the caller's object must not leak
        # into the collection (reference clones on add)
        self._add(name, timeseries.copy(), variable_type)

    def add_grid_timeseries(
        self, name: str, timeseries: GridTimeseries,
        variable_type: VariableType = VariableType.Exogenous,
    ):
        # store a copy: later mutation of the caller's object must not leak
        # into the collection (reference clones on add) — same contract as
        # the grid-specific adders above
        self._add(name, timeseries.copy(), variable_type)

    def extend(self, other: "TimeseriesCollection"):
        for item in other._items:
            # copies, like every other add path: mutating the source
            # collection afterwards must not alias into this one
            self._add(item.name, item.data.copy(), item.variable_type)

    # -- queries ------------------------------------------------------------

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __iter__(self):
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def names(self) -> list:
        return [item.name for item in self._items]

    def get_item(self, name: str) -> Optional[TimeseriesItem]:
        i = self._index.get(name)
        return self._items[i] if i is not None else None

    def get_data(self, name: str) -> Optional[GridTimeseries]:
        item = self.get_item(name)
        return item.data if item is not None else None

    def get_timeseries_by_name(self, name: str):
        """Scalar timeseries by name (clone), or None if absent/not scalar.

        The returned object's ``values()`` is the flat 1-D series, matching
        the reference's scalar ``Timeseries`` (callers index ``[1:]`` etc.);
        the internal 2-D layout stays on :meth:`get_data`.
        """
        item = self.get_item(name)
        if item is None or item.data.grid.size() != 1:
            return None
        data = item.data
        return _ScalarTimeseriesView(
            data.values(),
            data.time_axis(),
            data.grid,
            data.units,
            data.interpolation_strategy,
        )

    def get_fourbox_timeseries_by_name(self, name: str) -> Optional[GridTimeseries]:
        item = self.get_item(name)
        if item is None or item.data.grid.size() != 4:
            return None
        return item.data.copy()

    def get_hemispheric_timeseries_by_name(self, name: str) -> Optional[GridTimeseries]:
        item = self.get_item(name)
        if item is None or item.data.grid.size() != 2:
            return None
        return item.data.copy()

    def timeseries(self) -> list:
        """Clones of all *scalar* timeseries, sorted by name."""
        return [item.data.copy() for item in self._items if item.data.grid.size() == 1]

    def copy(self) -> "TimeseriesCollection":
        out = TimeseriesCollection()
        for item in self._items:
            out._add(item.name, item.data.copy(), item.variable_type)
        return out

    # -- grid-checked setters (mirror of set_scalar/set_four_box/...) -------

    def _get_data_or_raise(self, name: str) -> GridTimeseries:
        data = self.get_data(name)
        if data is None:
            raise KeyError(
                f"timeseries {name!r} not found in collection; "
                f"known: {self.names()}"
            )
        return data

    def set_scalar(self, name: str, index: int, value: float):
        data = self._get_data_or_raise(name)
        if data.grid.size() != 1:
            raise GridOutputMismatchError(name, "Scalar", data.grid.grid_name())
        data.set_index(index, 0, value)

    def set_four_box(self, name: str, index: int, values):
        data = self._get_data_or_raise(name)
        if data.grid.size() != 4:
            raise GridOutputMismatchError(name, "FourBox", data.grid.grid_name())
        data.set_from_slice(index, values)

    def set_hemispheric(self, name: str, index: int, values):
        data = self._get_data_or_raise(name)
        if data.grid.size() != 2:
            raise GridOutputMismatchError(name, "Hemispheric", data.grid.grid_name())
        data.set_from_slice(index, values)

    # -- serialisation ------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "timeseries": [
                {
                    "name": item.name,
                    "variable_type": item.variable_type.value,
                    "data": item.data.to_dict(),
                }
                for item in self._items
            ]
        }

    @staticmethod
    def from_dict(d: dict) -> "TimeseriesCollection":
        out = TimeseriesCollection()
        for entry in d["timeseries"]:
            out._add(
                entry["name"],
                GridTimeseries.from_dict(entry["data"]),
                VariableType(entry["variable_type"]),
            )
        return out

    def __repr__(self):
        names = ", ".join(f'"{n}"' for n in self.names())
        return f"<TimeseriesCollection names=[{names}]>"
