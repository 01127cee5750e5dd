"""``rscm._lib.core.state`` — slices, state values, windows."""

from rscm_tpu_torch.core.state import (  # noqa: F401
    FourBoxSlice,
    FourBoxWindow,
    HemisphericSlice,
    HemisphericWindow,
    ScalarWindow,
    StateValue,
    VariableSource,
)

# Reference window types (reference user-facing ergonomics)
from ..._windows import (  # noqa: F401
    FourBoxTimeseriesWindow,
    HemisphericTimeseriesWindow,
    TimeseriesWindow,
)

__all__ = [
    "FourBoxSlice",
    "FourBoxTimeseriesWindow",
    "FourBoxWindow",
    "HemisphericSlice",
    "HemisphericTimeseriesWindow",
    "HemisphericWindow",
    "ScalarWindow",
    "StateValue",
    "TimeseriesWindow",
    "VariableSource",
]
