"""
Core engine: the public surface mirrors ``rscm.core`` from the reference.

>>> from rscm_tpu_torch.core import ModelBuilder, TimeAxis, Timeseries
>>> import numpy as np
>>> model = (
...     ModelBuilder()
...     .with_time_axis(TimeAxis.from_values(np.arange(2000.0, 2101.0)))
...     .with_component(my_component)
...     .with_exogenous_variable("Emissions", emissions_ts)
... ).build()
>>> model.run()
>>> results = model.timeseries()
"""

from .component import (
    Component,
    Input,
    Output,
    Parameter,
    RequirementDefinition,
    RequirementType,
    SolveContext,
    State,
)
from .errors import RSCMError
from .interpolate import InterpolationKind, InterpolationStrategy, LinearSpline, Next, Previous
from .model import Model, ModelBuilder
from .schema import AggregateOp, VariableSchema
from .spatial import (
    FourBoxGrid,
    FourBoxRegion,
    GridType,
    HemisphericGrid,
    HemisphericRegion,
    ScalarGrid,
    ScalarRegion,
)
from .state import (
    FourBoxSlice,
    FourBoxWindow,
    HemisphericSlice,
    HemisphericWindow,
    ScalarWindow,
    StateValue,
    VariableSource,
)
from .time_axis import TimeAxis
from .timeseries import (
    GridTimeseries,
    Timeseries,
    TimeseriesCollection,
    VariableType,
)
from .units import Unit

# API-compat aliases matching the reference's class names
TimeseriesWindow = ScalarWindow
FourBoxTimeseriesWindow = FourBoxWindow
HemisphericTimeseriesWindow = HemisphericWindow

__all__ = [
    "AggregateOp",
    "Component",
    "FourBoxGrid",
    "FourBoxRegion",
    "FourBoxSlice",
    "FourBoxTimeseriesWindow",
    "FourBoxWindow",
    "GridTimeseries",
    "GridType",
    "HemisphericGrid",
    "HemisphericRegion",
    "HemisphericSlice",
    "HemisphericTimeseriesWindow",
    "HemisphericWindow",
    "Input",
    "InterpolationKind",
    "InterpolationStrategy",
    "LinearSpline",
    "Model",
    "ModelBuilder",
    "Next",
    "Output",
    "Parameter",
    "Previous",
    "RSCMError",
    "RequirementDefinition",
    "RequirementType",
    "ScalarGrid",
    "ScalarRegion",
    "ScalarWindow",
    "SolveContext",
    "State",
    "StateValue",
    "TimeAxis",
    "Timeseries",
    "TimeseriesCollection",
    "TimeseriesWindow",
    "Unit",
    "VariableSchema",
    "VariableSource",
    "VariableType",
]
