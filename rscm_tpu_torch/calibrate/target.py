"""
Calibration targets: observations with uncertainties per variable.

Port of ``rscm_tpu/calibrate/target.py`` (host code, no JAX), including
reference-period (anomaly) support.  :meth:`Target.compile` lowers the
observation set onto a model time axis as static index/value/uncertainty
arrays so the likelihood is a masked reduction over trajectory tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Observation", "VariableTarget", "Target", "CompiledTarget"]


@dataclass
class Observation:
    time: float
    value: float
    uncertainty: float

    def __post_init__(self):
        if self.uncertainty <= 0.0:
            raise ValueError("Uncertainty must be positive")


class VariableTarget:
    def __init__(self, name: str):
        self.name = name
        self.observations: List[Observation] = []
        self.reference_period: Optional[Tuple[float, float]] = None

    def add_observation(self, obs: Observation) -> "VariableTarget":
        self.observations.append(obs)
        self.observations.sort(key=lambda o: o.time)
        return self

    def add(self, time: float, value: float, uncertainty: float) -> "VariableTarget":
        return self.add_observation(Observation(time, value, uncertainty))

    def add_relative(self, time: float, value: float, relative_uncertainty: float):
        return self.add(time, value, abs(value) * relative_uncertainty)

    def with_reference_period(self, start: float, end: float) -> "VariableTarget":
        self.reference_period = (start, end)
        return self

    def observations_in_range(self, start: float, end: float) -> List[Observation]:
        return [o for o in self.observations if start <= o.time <= end]

    def time_range(self):
        if not self.observations:
            return None
        return (self.observations[0].time, self.observations[-1].time)

    def __repr__(self):
        return f"VariableTarget({self.name!r}, {len(self.observations)} obs)"


class Target:
    def __init__(self):
        self.variables: Dict[str, VariableTarget] = {}

    def add_variable(self, name: str) -> VariableTarget:
        if name not in self.variables:
            self.variables[name] = VariableTarget(name)
        return self.variables[name]

    def add_observation(
        self, name: str, time: float, value: float, uncertainty: float
    ) -> "Target":
        """Fluent single-call observation add (reference python API)."""
        self.add_variable(name).add(time, value, uncertainty)
        return self

    def add_observation_relative(
        self, name: str, time: float, value: float, relative_uncertainty: float
    ) -> "Target":
        self.add_variable(name).add_relative(time, value, relative_uncertainty)
        return self

    def set_reference_period(self, name: str, start: float, end: float) -> "Target":
        """Anomaly target: model values are referenced to this period's mean."""
        self.add_variable(name).with_reference_period(start, end)
        return self

    def get_variable(self, name: str) -> Optional[VariableTarget]:
        return self.variables.get(name)

    def variable_names(self) -> list:
        return list(self.variables)

    def total_observations(self) -> int:
        return sum(len(v.observations) for v in self.variables.values())

    def compile(self, time_axis, collection=None) -> "CompiledTarget":
        """Lower onto a model time axis (and optionally its collection).

        ``collection`` supplies each variable's spatial grid: targets on
        grid variables (e.g. the FourBox ``Surface Temperature``) compare
        observations against the **area-weighted global aggregate** of the
        trajectory — the same reduction as ``SpatialGrid.aggregate_global``.
        Without a collection, grid trajectories fall back to region 0.
        """
        return CompiledTarget(self, time_axis, collection)

    def __repr__(self):
        return f"Target({list(self.variables)})"


class CompiledTarget:
    """Target lowered onto a model time axis as static arrays.

    Per variable: observation time-axis indices (nearest-match within
    1e-6), values, uncertainties, and an optional reference-period index
    array for anomaly targets.  When a ``collection`` is given and the
    variable lives on a multi-region grid, ``grid_weights`` holds the
    grid's area weights so the likelihood compares the global aggregate
    (``aggregate_global`` semantics).
    """

    def __init__(self, target: Target, time_axis, collection=None):
        self.target = target
        self.time_axis = time_axis
        values = np.asarray(time_axis.values())
        self.per_variable = {}
        for name, vt in target.variables.items():
            grid_weights = None
            if collection is not None:
                data = collection.get_data(name)
                if data is not None and data.grid.size() > 1:
                    grid_weights = np.asarray(data.grid.weights, dtype=np.float64)
            idxs, obs_vals, sigmas = [], [], []
            for obs in vt.observations:
                matches = np.nonzero(np.abs(values - obs.time) < 1e-6)[0]
                if len(matches) == 0:
                    raise ValueError(
                        f"Observation time {obs.time} for '{name}' is not on the "
                        f"model time axis"
                    )
                idxs.append(int(matches[0]))
                obs_vals.append(obs.value)
                sigmas.append(obs.uncertainty)
            ref_idx = None
            if vt.reference_period is not None:
                start, end = vt.reference_period
                ref_idx = np.nonzero((values >= start) & (values <= end))[0]
                if len(ref_idx) == 0:
                    raise ValueError(
                        f"Reference period {vt.reference_period} for '{name}' "
                        f"contains no model time steps"
                    )
            self.per_variable[name] = {
                "indices": np.asarray(idxs, dtype=np.int32),
                "values": np.asarray(obs_vals),
                "sigmas": np.asarray(sigmas),
                "reference_indices": ref_idx,
                "grid_weights": grid_weights,
            }
