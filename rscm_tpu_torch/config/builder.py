"""Config-driven model assembly
(mirror of python/rscm/config/builder.py:19-108).

``build_model`` dispatches on ``model.type``; model-family builders read the
component parameter tables, pull builders from the registry, and assemble a
:class:`~rscm_tpu_torch.core.model.Model`.
"""

from __future__ import annotations

from dataclasses import asdict, is_dataclass
from typing import Any

import numpy as np

from .registry import component_registry

__all__ = ["build_model", "build_two_layer_model"]


def build_model(config: Any):
    """Build a model from a ModelConfig instance or a TOML dict."""
    if isinstance(config, dict):
        model_type = config.get("model", {}).get("type", "")
    else:
        model_type = config.model_type
    if model_type == "two-layer":
        return build_two_layer_model(config)
    raise ValueError(f"Unknown model type: {model_type!r}")


def _extract(config: Any):
    if isinstance(config, dict):
        components = config.get("components", {})
        time_config = config.get("time", {})
        initial_values = config.get("initial_values", {}) or {}
        inputs = config.get("inputs", {}) or {}
        base_dir = config.get("_base_dir")
    else:
        components = {
            "climate": {
                "parameters": asdict(config.climate)
                if hasattr(config, "climate") and is_dataclass(config.climate)
                else {}
            }
        }
        time_config = (
            {"start": config.time.start, "end": config.time.end}
            if getattr(config, "time", None)
            else {}
        )
        initial_values = getattr(config, "initial_values", {}) or {}
        inputs = getattr(config, "inputs", {}) or {}
        base_dir = None
    return components, time_config, initial_values, inputs, base_dir


def _resolve_inputs(inputs: dict, time_config: dict, base_dir):
    """Input specs -> Timeseries: ``{file=..}`` loads a scenario CSV (also
    accepts :class:`~rscm_tpu_torch.config.base.InputSpec` dataclasses);
    ``{values=[..], times=[..]}`` builds inline data; a bare number is a
    constant over the model's time span.  ``required`` specs without a
    usable file are a hard error; optional incomplete specs are skipped."""
    from rscm_tpu_torch.core import TimeAxis, Timeseries
    from rscm_tpu_torch.core.spatial import ScalarGrid

    out = {}
    for name, spec in (inputs or {}).items():
        if is_dataclass(spec) and not isinstance(spec, type):
            # typed configs carry InputSpec dataclasses (config/base.py)
            if getattr(spec, "file", None) is None:
                if getattr(spec, "required", False):
                    raise ValueError(
                        f"input '{name}': required but no file given "
                        f"({spec!r})"
                    )
                continue  # optional input not provided
            from rscm_tpu_torch.utils.scenario_io import load_input_spec

            out[name] = load_input_spec(name, spec, base_dir=base_dir)
        elif isinstance(spec, dict) and spec.get("file"):
            from rscm_tpu_torch.utils.scenario_io import load_input_spec

            out[name] = load_input_spec(
                name, spec, base_dir=spec.get("_base_dir", base_dir)
            )
        elif isinstance(spec, dict) and spec.get("required") and "values" not in spec:
            raise ValueError(
                f"input '{name}': required but no file or inline values "
                f"given ({spec!r})"
            )
        elif isinstance(spec, dict) and "values" in spec:
            times = np.asarray(spec["times"], dtype=float)
            values = np.asarray(spec["values"], dtype=float)
            out[name] = Timeseries(
                values, TimeAxis.from_values(times), ScalarGrid(),
                spec.get("unit", ""),
            )
        elif isinstance(spec, (int, float)):
            start = float(time_config.get("start", 1750))
            end = float(time_config.get("end", 2100))
            times = np.asarray([start, end])
            out[name] = Timeseries(
                np.asarray([float(spec), float(spec)]),
                TimeAxis.from_values(times), ScalarGrid(), "",
            )
        else:
            raise ValueError(f"input '{name}': unsupported spec {spec!r}")
    return out


def build_two_layer_model(config: Any):
    from rscm_tpu_torch.core import ModelBuilder, TimeAxis
    from . import models  # noqa: F401  (side-effect: registers builders)

    components, time_config, initial_values, inputs, base_dir = _extract(config)
    params = components.get("climate", {}).get("parameters", {})

    builder_cls = component_registry.get("TwoLayer")
    component = builder_cls.from_parameters(params).build()

    model_builder = ModelBuilder()
    if time_config:
        start = time_config.get("start", 1750)
        end = time_config.get("end", 2100)
        model_builder = model_builder.with_time_axis(
            TimeAxis.from_values(np.arange(start, end + 1, dtype=float))
        )
    model_builder = model_builder.with_component(component)

    for name, spec in _resolve_inputs(inputs, time_config, base_dir).items():
        model_builder = model_builder.with_exogenous_variable(name, spec)

    defaults = {"Surface Temperature": 0.0, "Deep Ocean Temperature": 0.0}
    defaults.update(initial_values)
    model_builder = model_builder.with_initial_values(defaults)
    return model_builder.build()
