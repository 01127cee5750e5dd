"""
Core classes for simple climate models (reference-API surface).

Re-exports the port's engine types under the names of ``rscm.core``
(``python/rscm/core.py`` / ``python/rscm/_lib/core/__init__.pyi``),
including the reference's constructor signatures where they differ:

- ``Timeseries(values_1d, time_axis, units, interpolation_strategy)``
- ``InterpolationStrategy.Linear / .Next / .Previous`` (extrapolating)
"""

from __future__ import annotations

import numpy as np

from rscm_tpu_torch.core import (
    GridType,
    Model,
    ModelBuilder,
    RequirementDefinition,
    RequirementType,
    TimeAxis,
    TimeseriesCollection,
    Unit,
    VariableSchema,
    VariableType,
)
from rscm_tpu_torch.core.interpolate import (
    InterpolationKind,
    InterpolationStrategy as _Strategy,
)
from rscm_tpu_torch.core.python_component import PythonComponent
from rscm_tpu_torch.core.spatial import (
    FourBoxGrid,
    FourBoxRegion,
    HemisphericGrid,
    HemisphericRegion,
    ScalarGrid,
    ScalarRegion,
)
from rscm_tpu_torch.core.state import (
    FourBoxSlice,
    HemisphericSlice,
    StateValue,
)
from rscm_tpu_torch.core.timeseries import GridTimeseries

from ._windows import (
    FourBoxTimeseriesWindow,
    HemisphericTimeseriesWindow,
    TimeseriesWindow,
)


class InterpolationStrategy:
    """Enum-style strategies matching the reference Python binding
    (``python/timeseries.rs:55-72``): all extrapolate."""

    Linear = _Strategy(InterpolationKind.Linear, True)
    Next = _Strategy(InterpolationKind.Next, True)
    Previous = _Strategy(InterpolationKind.Previous, True)


class Timeseries(GridTimeseries):
    """Scalar timeseries with the reference's constructor signature."""

    def __init__(self, values, time_axis, units="", interpolation_strategy=None):
        values = np.asarray(values, dtype=np.float64)
        if values.ndim == 1:
            values = values[:, None]
        super().__init__(
            values, time_axis, ScalarGrid(), units,
            interpolation_strategy or InterpolationStrategy.Linear,
        )

    def values(self):  # reference returns the flat 1-D array
        return super().values()[:, 0]


class FourBoxTimeseries(GridTimeseries):
    """FourBox grid timeseries (4 regional values per step)."""

    def __init__(self, values, time_axis, units="", interpolation_strategy=None):
        super().__init__(
            values, time_axis, FourBoxGrid.magicc_standard(), units,
            interpolation_strategy or InterpolationStrategy.Linear,
        )


class HemisphericTimeseries(GridTimeseries):
    """Hemispheric grid timeseries (2 regional values per step)."""

    def __init__(self, values, time_axis, units="", interpolation_strategy=None):
        super().__init__(
            values, time_axis, HemisphericGrid.equal_weights(), units,
            interpolation_strategy or InterpolationStrategy.Linear,
        )


__all__ = [
    "FourBoxGrid",
    "FourBoxRegion",
    "FourBoxSlice",
    "FourBoxTimeseries",
    "FourBoxTimeseriesWindow",
    "GridType",
    "HemisphericGrid",
    "HemisphericRegion",
    "HemisphericSlice",
    "HemisphericTimeseries",
    "HemisphericTimeseriesWindow",
    "InterpolationStrategy",
    "Model",
    "ModelBuilder",
    "PythonComponent",
    "RequirementDefinition",
    "RequirementType",
    "ScalarGrid",
    "ScalarRegion",
    "StateValue",
    "TimeAxis",
    "Timeseries",
    "TimeseriesCollection",
    "TimeseriesWindow",
    "Unit",
    "VariableSchema",
    "VariableType",
]
