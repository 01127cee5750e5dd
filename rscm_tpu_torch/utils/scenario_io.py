"""
Scenario file IO: wide-format CSV → exogenous timeseries.

The reference declares scenario inputs in TOML as
``"Variable" = { file = "data/x.csv", unit = "..." }`` (config/base.py
InputSpec) and reads scenario CSVs through pandas in its test tooling;
this module is the engine's loader for that format, backed by the native
CSV parser (``rscm_tpu_torch.native.csv``) with a pure-Python fallback.
Port of the JAX package's ``utils/scenario_io.py``.

Format: first column is time (named ``time`` / ``year``/``years``,
case-insensitive), one column per variable:

    time,Emissions|CO2,Effective Radiative Forcing
    1750.0,0.0,0.0
    1751.0,0.02,0.01
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.spatial import ScalarGrid
from ..core.time_axis import TimeAxis
from ..core.timeseries import Timeseries
from ..native.csv import read_numeric_csv

__all__ = ["load_scenario_csv", "load_input_spec"]

_TIME_NAMES = {"time", "year", "years", "t"}


def load_scenario_csv(
    path,
    units: Optional[Dict[str, str]] = None,
    interpolation_strategy=None,
) -> Dict[str, Timeseries]:
    """Load a wide-format scenario CSV into ``{variable: Timeseries}``.

    ``units`` optionally maps variable name -> unit string (TOML input
    specs carry units separately from the data file).
    """
    header, values = read_numeric_csv(path)
    if len(header) < 2:
        raise ValueError(f"{path}: need a time column plus at least one variable")
    if header[0].strip().lower() not in _TIME_NAMES:
        raise ValueError(
            f"{path}: first column must be the time axis "
            f"(named one of {sorted(_TIME_NAMES)}), got '{header[0]}'"
        )
    if values.shape[0] < 2:
        raise ValueError(f"{path}: need at least two time points")

    times = values[:, 0]
    if np.any(np.diff(times) <= 0):
        raise ValueError(f"{path}: time column must be strictly increasing")

    axis = TimeAxis.from_values(np.ascontiguousarray(times))
    units = units or {}
    out = {}
    for j, name in enumerate(header[1:], start=1):
        out[name] = Timeseries(
            np.ascontiguousarray(values[:, j]),
            axis,
            ScalarGrid(),
            units.get(name, ""),
            interpolation_strategy,
        )
    return out


def load_input_spec(name: str, spec, base_dir=None) -> Timeseries:
    """Load one TOML input spec ``{file=..., unit=...}`` as a Timeseries.

    The CSV may be wide-format; the column matching ``name`` is used
    (or the only variable column when there is just one).
    """
    from pathlib import Path

    file = spec.get("file") if isinstance(spec, dict) else getattr(spec, "file", None)
    unit = spec.get("unit", "") if isinstance(spec, dict) else getattr(spec, "unit", "")
    if file is None:
        raise ValueError(f"input '{name}': no file given in spec {spec!r}")
    path = Path(base_dir) / file if base_dir is not None else Path(file)

    series = load_scenario_csv(path, units={name: unit} if unit else None)
    if name in series:
        ts = series[name]
    elif len(series) == 1:
        import warnings

        only = next(iter(series))
        warnings.warn(
            f"input '{name}': column not found in {path}; using the file's "
            f"only data column '{only}'",
            stacklevel=2,
        )
        ts = next(iter(series.values()))
    else:
        raise KeyError(
            f"input '{name}': column not found in {path} "
            f"(columns: {sorted(series)})"
        )
    if unit:
        ts.units = unit
    return ts
