"""
PythonComponent: run arbitrary user Python components in a model.

Mirror of ``crates/rscm-core/src/python/component.rs:110-304``:

- **typed path** (object exposes ``_component_inputs`` — e.g. subclasses of
  the typed :class:`~rscm_tpu.core.component.Component` API): windows are
  built from copies of the history up to the current index (so ``at_end``
  is ``None`` during solve, exactly like the reference's window copies) and
  passed through ``Inputs.from_input_state``;
- **legacy dict path**: ``solve(t, t_next, {name: latest_global_value})``
  returning a dict of floats / StateValues.

Python components run on the step-by-step executor only: a model
containing one steps instead of taking the year loop (the program refuses
it up front).  The user's code sees what it sees in the TPU package — host
floats, numpy windows and ``StateValue``s — never device tensors: the
windows the executor hands over are unwrapped to their host windows.
Users wanting the year loop subclass the typed Component API with tensor
arithmetic, which runs there without this wrapper.
"""

from __future__ import annotations

import numpy as np

from .component import RequirementType
from .state import StateValue, host_window

__all__ = ["PythonComponent"]


class PythonComponent:
    """Adapter from a user Python object to the component protocol."""

    #: models containing this component cannot run in the year loop
    traceable = False

    def __init__(self, component):
        self.component = component

    @staticmethod
    def build(component) -> "PythonComponent":
        return PythonComponent(component)

    @property
    def component_name(self) -> str:
        return type(self.component).__name__

    # -- requirement surface -------------------------------------------------

    def definitions(self):
        return list(self.component.definitions())

    def inputs(self):
        return [
            d
            for d in self.definitions()
            if d.requirement_type in (RequirementType.Input, RequirementType.State)
        ]

    def input_names(self):
        return [d.name for d in self.inputs()]

    def outputs(self):
        return [
            d
            for d in self.definitions()
            if d.requirement_type in (RequirementType.Output, RequirementType.State)
        ]

    def output_names(self):
        return [d.name for d in self.outputs()]

    def param_pytree(self):
        return {}

    def with_params(self, pytree):
        return self

    def create_initial_state(self):
        return None

    # -- solve -----------------------------------------------------------------

    def _truncated_windows(self, input_state):
        """Window copies over history 0..=N (python/component.rs:237-304)."""
        windows = {}
        for name in input_state.names():
            window = host_window(input_state.get_window(name))
            idx = int(window.current_index)
            truncated = type(window)(
                np.asarray(window.values[: idx + 1]),
                idx,
                window.current_time,
                factor=window.factor,
                source=window.source,
                strategy=window.strategy,
                time_values=(
                    np.asarray(window.time_values[: idx + 1])
                    if window.time_values is not None
                    else None
                ),
                grid=window.grid,
            )
            windows[name] = truncated
        return windows

    def _legacy_dict(self, input_state):
        """{name: latest global value} (state/mod.rs ``to_hashmap``)."""
        out = {}
        for name in input_state.names():
            window = host_window(input_state.get_window(name))
            values = np.asarray(window.values)
            valid = ~np.any(np.isnan(values), axis=1)
            idx = int(np.nonzero(valid)[0][-1]) if valid.any() else 0
            row = values[idx] * window.factor
            if row.shape[0] == 1:
                out[name] = float(row[0])
            else:
                out[name] = float(np.dot(row, window.grid.weights))
        return out

    def solve_ctx(self, ctx, input_state, internal_state):
        is_typed = hasattr(self.component, "_component_inputs")
        if is_typed:
            windows = self._truncated_windows(input_state)
            typed_inputs = self.component.Inputs.from_input_state(windows)
            result = self.component.solve(ctx.t_current, ctx.t_next, typed_inputs)
            result = result.to_dict()
        else:
            result = self.component.solve(
                ctx.t_current, ctx.t_next, self._legacy_dict(input_state)
            )
        if not isinstance(result, dict):
            raise TypeError("solve() must return a dict")
        outputs = {}
        for key, value in result.items():
            if isinstance(value, StateValue):
                outputs[key] = value
            elif np.isscalar(value) or isinstance(value, (int, float, np.floating)):
                outputs[key] = StateValue.scalar(float(value))
            else:
                outputs[key] = StateValue.wrap(value)
        return outputs, internal_state

    def __repr__(self):
        return f"PythonComponent({type(self.component).__name__})"
