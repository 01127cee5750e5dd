"""
Component abstraction: requirement declarations + typed I/O + solve.

Mirrors two reference surfaces at once:

- the Rust ``Component`` trait + ``#[derive(ComponentIO)]`` macro
  (``crates/rscm-core/src/component.rs:351-437``,
  ``crates/rscm-macros/src/lib.rs``): declarative inputs/outputs/states with
  name/unit/grid metadata, generated ``Inputs``/``Outputs`` classes and
  ``definitions()``;
- the typed Python component API (``python/rscm/component.py:115-563``):
  ``Input``/``Output``/``State`` class descriptors + a metaclass generating
  the same machinery, with a component registry for doc generation.

Components declare their **parameters** via :func:`Parameter` descriptors
(or by overriding ``param_pytree``).  The model program substitutes the
values for a run with ``with_params``: a Python float for a parameter every
member shares, a ``(members,)`` tensor for a swept one, so one component
object serves a whole ensemble with the member axis written out.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from enum import Enum
from typing import Any, ClassVar, Dict, Optional

import numpy as np
import torch

from .spatial import GridType
from .state import FourBoxSlice, HemisphericSlice, StateValue

__all__ = [
    "RequirementType",
    "RequirementDefinition",
    "Input",
    "Output",
    "State",
    "Parameter",
    "Component",
    "ComponentMeta",
    "OutputState",
    "SolveContext",
    "state_to_host",
    "state_to_tensors",
]


class RequirementType(Enum):
    Input = "Input"
    Output = "Output"
    State = "State"
    EmptyLink = "EmptyLink"


@dataclass(eq=True)
class RequirementDefinition:
    """A named variable requirement with unit and grid.

    Mirror of ``component.rs:85-165`` including the convenience
    constructors.
    """

    name: str
    unit: str
    requirement_type: RequirementType
    grid_type: GridType = GridType.Scalar

    def __hash__(self):
        return hash((self.name, self.unit, self.requirement_type, self.grid_type))

    @staticmethod
    def scalar_input(name, unit):
        return RequirementDefinition(name, unit, RequirementType.Input)

    @staticmethod
    def scalar_output(name, unit):
        return RequirementDefinition(name, unit, RequirementType.Output)

    @staticmethod
    def scalar_state(name, unit):
        return RequirementDefinition(name, unit, RequirementType.State)

    @staticmethod
    def four_box_input(name, unit):
        return RequirementDefinition(name, unit, RequirementType.Input, GridType.FourBox)

    @staticmethod
    def four_box_output(name, unit):
        return RequirementDefinition(name, unit, RequirementType.Output, GridType.FourBox)

    @staticmethod
    def four_box_state(name, unit):
        return RequirementDefinition(name, unit, RequirementType.State, GridType.FourBox)

    @staticmethod
    def hemispheric_input(name, unit):
        return RequirementDefinition(name, unit, RequirementType.Input, GridType.Hemispheric)

    @staticmethod
    def hemispheric_output(name, unit):
        return RequirementDefinition(name, unit, RequirementType.Output, GridType.Hemispheric)

    @staticmethod
    def hemispheric_state(name, unit):
        return RequirementDefinition(name, unit, RequirementType.State, GridType.Hemispheric)

    def is_spatial(self) -> bool:
        return self.grid_type is not GridType.Scalar


def _parse_grid(grid) -> GridType:
    if isinstance(grid, GridType):
        return grid
    if grid in ("Scalar", "FourBox", "Hemispheric"):
        return GridType(grid)
    raise ValueError(f"Unknown grid type: {grid}. Must be Scalar, FourBox, or Hemispheric")


@dataclass(frozen=True)
class Input:
    """Declare an input variable (class attribute descriptor).

    ``lookback`` is the deepest step offset before N this component reads
    of the variable (``previous()`` → 1, ``at_offset(-k)`` → k,
    ``last_n(n)`` → n-1).  The streaming scan program sizes the variable's
    carried window from the max lookback over all readers, so a component
    that reads deeper than it declares would silently get clamped values.
    """

    name: str
    unit: str = ""
    grid: str = "Scalar"
    description: str = ""
    lookback: int = 1

    def to_requirement(self) -> RequirementDefinition:
        return RequirementDefinition(self.name, self.unit, RequirementType.Input, _parse_grid(self.grid))


@dataclass(frozen=True)
class Output:
    """Declare an output variable (class attribute descriptor)."""

    name: str
    unit: str = ""
    grid: str = "Scalar"
    description: str = ""

    def to_requirement(self) -> RequirementDefinition:
        return RequirementDefinition(self.name, self.unit, RequirementType.Output, _parse_grid(self.grid))


@dataclass(frozen=True)
class State:
    """Declare a state variable (read previous value, write new value).

    ``lookback`` — see :class:`Input`.
    """

    name: str
    unit: str = ""
    grid: str = "Scalar"
    description: str = ""
    lookback: int = 1

    def to_requirement(self) -> RequirementDefinition:
        return RequirementDefinition(self.name, self.unit, RequirementType.State, _parse_grid(self.grid))


class _Required:
    """Sentinel distinguishing "no default declared" (required — mirrors the
    reference's non-Option serde fields, which fail deserialization when
    absent) from an explicit ``default=None`` (optional — mirrors Option
    fields defaulting to None)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<required>"


REQUIRED = _Required()


@dataclass(frozen=True)
class Parameter:
    """Declare a numeric parameter that a run may set per member.

    ``default`` may be a float or an array-like; ``static=True`` keeps the
    parameter out of the per-member parameters (a build-time constant — use for
    integers/flags that select code paths).  Omitting ``default`` marks the
    parameter required: ``from_parameters`` raises ``missing field`` when it
    is absent, and direct construction warns at model build time.  An
    explicit ``default=None`` declares an *optional* parameter.
    """

    default: Any = REQUIRED
    description: str = ""
    unit: str = ""
    static: bool = False


# OutputState is a plain dict name -> StateValue (mirror of state/mod.rs:606)
OutputState = Dict[str, StateValue]


@dataclass
class SolveContext:
    """Per-step scalars handed to solve: times and the step index.

    ``t_current``/``t_next`` are the half-open step bounds; ``step_index``
    is the model step N (an int).
    ``spans`` carries the *static* (host) step widths of the whole time axis
    so per-component sub-stepping (RK4, monthly loops) can resolve static
    iteration counts on the host.
    """

    t_current: Any
    t_next: Any
    step_index: Any = 0
    spans: Any = None
    #: True only inside ModelProgram's year loop — components whose loop
    #: state uses a program-packed layout (see pack_scan_state hooks) must
    #: branch on this, NOT on whether inputs are tensors
    scan_mode: bool = False

    @property
    def dt(self):
        return self.t_next - self.t_current


def state_to_tensors(state, dtype, device):
    """A host-layout internal state as the year loop takes it: float leaves
    as tensors of ``dtype`` on ``device``, other leaves as they are."""
    if state is None:
        return None

    def cast(leaf):
        if isinstance(leaf, torch.Tensor):  # e.g. left on the card by step()
            return leaf.to(dtype=dtype, device=device) if leaf.is_floating_point() else leaf
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating):
            return torch.as_tensor(arr, dtype=dtype, device=device)
        return leaf

    return {k: cast(v) for k, v in state.items()}


def state_to_host(state, like):
    """A year-loop internal state back in the host layout of ``like`` (the
    state it started from): numpy leaves, without the member axis of a
    one-member run where ``like``'s leaf has none, and Python floats where
    ``like`` has them."""
    return {k: _host_leaf(v, like.get(k)) for k, v in state.items()}


def _host_leaf(leaf, like):
    arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    if like is not None and arr.shape == (1,) + np.shape(like):
        arr = arr[0]
    if isinstance(like, float):
        return float(arr)
    return arr


def _get_window_field_doc(grid: str) -> str:
    return {
        "Scalar": "ScalarWindow",
        "FourBox": "FourBoxWindow",
        "Hemispheric": "HemisphericWindow",
    }[grid]


def _create_inputs_class(component_name, inputs, states):
    field_to_var = {}
    for field_name, decl in {**inputs, **states}.items():
        field_to_var[field_name] = (decl.name, decl.grid)

    class InputsBase:
        _field_to_var: ClassVar[dict] = field_to_var

        def __init__(self, **kwargs):
            for name, value in kwargs.items():
                setattr(self, name, value)

        @classmethod
        def from_input_state(cls, input_state):
            """Build typed inputs from a mapping of variable name -> window."""
            kwargs = {}
            for field_name, (var_name, _grid) in cls._field_to_var.items():
                if hasattr(input_state, "get_window"):
                    kwargs[field_name] = input_state.get_window(var_name)
                else:
                    if var_name not in input_state:
                        raise KeyError(f"Missing required input: {var_name}")
                    kwargs[field_name] = input_state[var_name]
            return cls(**kwargs)

        def __repr__(self):
            fields = ", ".join(f"{n}={getattr(self, n, None)!r}" for n in self._field_to_var)
            return f"{self.__class__.__name__}({fields})"

    InputsBase.__name__ = f"{component_name}Inputs"
    InputsBase.__qualname__ = f"{component_name}.Inputs"
    return InputsBase


def _create_outputs_class(component_name, outputs, states):
    field_info = {}
    for field_name, decl in {**outputs, **states}.items():
        field_info[field_name] = (decl.name, decl.grid)
    required = set(field_info)

    class OutputsBase:
        _field_info: ClassVar[dict] = field_info
        _required_fields: ClassVar[set] = required

        def __init__(self, **kwargs):
            missing = self._required_fields - set(kwargs)
            if missing:
                raise TypeError(
                    f"Missing required output fields: {', '.join(sorted(missing))}"
                )
            extra = set(kwargs) - self._required_fields
            if extra:
                raise TypeError(f"Unknown output fields: {', '.join(sorted(extra))}")
            for name, value in kwargs.items():
                setattr(self, name, value)

        def to_dict(self) -> OutputState:
            result = {}
            for field_name, (var_name, grid) in self._field_info.items():
                value = getattr(self, field_name)
                if isinstance(value, StateValue):
                    result[var_name] = value
                elif isinstance(value, FourBoxSlice):
                    result[var_name] = StateValue.four_box(value)
                elif isinstance(value, HemisphericSlice):
                    result[var_name] = StateValue.hemispheric(value)
                elif grid == "FourBox":
                    result[var_name] = StateValue.four_box(FourBoxSlice.from_array(value))
                elif grid == "Hemispheric":
                    result[var_name] = StateValue.hemispheric(
                        HemisphericSlice.from_array(value)
                    )
                else:
                    result[var_name] = StateValue.scalar(value)
            return result

        def __repr__(self):
            fields = ", ".join(f"{n}={getattr(self, n, None)!r}" for n in self._field_info)
            return f"{self.__class__.__name__}({fields})"

    OutputsBase.__name__ = f"{component_name}Outputs"
    OutputsBase.__qualname__ = f"{component_name}.Outputs"
    return OutputsBase


class ComponentMeta(type):
    """Collects Input/Output/State/Parameter declarations; generates
    ``Inputs``/``Outputs`` classes and parameter bookkeeping."""

    def __new__(mcs, name, bases, namespace, **kwargs):
        inputs, outputs, states, parameters = {}, {}, {}, {}
        for base in bases:
            inputs.update(getattr(base, "_component_inputs", {}))
            outputs.update(getattr(base, "_component_outputs", {}))
            states.update(getattr(base, "_component_states", {}))
            parameters.update(getattr(base, "_component_parameters", {}))

        for attr_name, attr_value in list(namespace.items()):
            if isinstance(attr_value, Input):
                inputs[attr_name] = attr_value
            elif isinstance(attr_value, Output):
                outputs[attr_name] = attr_value
            elif isinstance(attr_value, State):
                states[attr_name] = attr_value
            elif isinstance(attr_value, Parameter):
                parameters[attr_name] = attr_value

        namespace["_component_inputs"] = inputs
        namespace["_component_outputs"] = outputs
        namespace["_component_states"] = states
        namespace["_component_parameters"] = parameters

        # Parameter descriptors become instance attributes with defaults;
        # remove the class-level descriptor so instance values shadow.
        for pname in parameters:
            namespace.pop(pname, None)

        cls = super().__new__(mcs, name, bases, namespace, **kwargs)

        if name != "Component" and (inputs or outputs or states):
            cls.Inputs = _create_inputs_class(name, inputs, states)
            cls.Outputs = _create_outputs_class(name, outputs, states)
        return cls


class Component(metaclass=ComponentMeta):
    """Base class for typed components.

    Subclasses declare I/O with :class:`Input`/:class:`Output`/:class:`State`
    descriptors and parameters with :class:`Parameter`, then implement
    ``solve(t_current, t_next, inputs) -> Outputs``.

    The same ``solve`` body serves the eager host path (float64 numpy) and
    the batched year loop (torch tensors) — write physics with plain
    arithmetic and :mod:`rscm_tpu_torch.core.xmath` functions.
    """

    _registry: ClassVar[dict] = {}
    _component_inputs: ClassVar[dict] = {}
    _component_outputs: ClassVar[dict] = {}
    _component_states: ClassVar[dict] = {}
    _component_parameters: ClassVar[dict] = {}

    #: Tags/category for documentation (mirror of #[component(tags, category)])
    tags: ClassVar[tuple] = ()
    category: ClassVar[Optional[str]] = None

    Inputs: ClassVar[type]
    Outputs: ClassVar[type]

    def __init__(self, **params):
        for pname, decl in self._component_parameters.items():
            value = params.pop(pname, decl.default)
            if value is REQUIRED:
                # unset required parameter: keep the attribute None so run
                # semantics stay print-and-skip (runtime.rs:493-495); the
                # builder warns at build time (_warn_unset_parameters)
                value = None
            setattr(self, pname, value)
        if params:
            raise TypeError(
                f"Unknown parameters for {type(self).__name__}: {sorted(params)}"
            )

    def __init_subclass__(cls, register: bool = True, **kwargs):
        super().__init_subclass__(**kwargs)
        if register:
            Component._registry[cls.__name__] = cls

    @classmethod
    def get_registered_components(cls):
        return dict(cls._registry)

    @classmethod
    def get_component(cls, name: str):
        if name not in cls._registry:
            raise KeyError(
                f"No component registered with name '{name}'. "
                f"Available: {', '.join(sorted(cls._registry))}"
            )
        return cls._registry[name]

    #: accepted alternate spellings for parameters (serde-alias parity)
    parameter_aliases: ClassVar[dict] = {}

    @classmethod
    def from_parameters(cls, parameters: dict):
        """Construct from a flat parameter dict (builder-macro parity).

        Mirrors the reference's serde deserialisation
        (``pythonize::depythonize``): non-mapping input and missing
        required (no-default) fields raise ``ValueError`` with serde's
        message shapes; unknown keys are ignored with a warning (no
        ``deny_unknown_fields``).
        """
        import warnings
        from collections.abc import Mapping

        if not isinstance(parameters, Mapping):
            raise ValueError(
                f"unexpected type: {type(parameters).__name__!r} object "
                "cannot be cast as 'Mapping'"
            )

        known = cls._component_parameters
        for pname, decl in known.items():
            if decl.default is REQUIRED and pname not in parameters:
                provided = {
                    cls.parameter_aliases.get(k, k) for k in parameters
                }
                if pname not in provided:
                    raise ValueError(f"missing field `{pname}`")
        cleaned = {}
        for key, value in parameters.items():
            key = cls.parameter_aliases.get(key, key)
            if key in known:
                cleaned[key] = value
            else:
                warnings.warn(
                    f"{cls.__name__}.from_parameters: ignoring unknown parameter "
                    f"'{key}'",
                    stacklevel=2,
                )
        return cls(**cleaned)

    # -- requirement surface (Component trait parity) -----------------------

    def definitions(self) -> list:
        defs = []
        for decl in self._component_inputs.values():
            defs.append(decl.to_requirement())
        for decl in self._component_outputs.values():
            defs.append(decl.to_requirement())
        for decl in self._component_states.values():
            defs.append(decl.to_requirement())
        return defs

    def inputs(self) -> list:
        return [
            d
            for d in self.definitions()
            if d.requirement_type in (RequirementType.Input, RequirementType.State)
        ]

    def input_names(self) -> list:
        return [d.name for d in self.inputs()]

    def outputs(self) -> list:
        return [
            d
            for d in self.definitions()
            if d.requirement_type in (RequirementType.Output, RequirementType.State)
        ]

    def output_names(self) -> list:
        return [d.name for d in self.outputs()]

    @property
    def component_name(self) -> str:
        return type(self).__name__

    def input_lookback(self, var_name: str) -> int:
        """Deepest step offset before N this component reads of ``var_name``.

        The default comes from the Input/State declarations' ``lookback``
        (at least 1, covering ``previous()``).  Components whose history
        depth depends on a static parameter override this — the streaming
        scan program (:mod:`rscm_tpu_torch.core.model.program`) sizes each
        variable's carried window from the max over all readers.
        """
        lookback = 1
        for decl in (*self._component_inputs.values(), *self._component_states.values()):
            if decl.name == var_name:
                lookback = max(lookback, getattr(decl, "lookback", 1))
        return lookback

    # -- parameters (per-member values substituted per run) ----------------

    def param_pytree(self) -> dict:
        """Non-static parameters as a flat dict."""
        return {
            pname: getattr(self, pname)
            for pname, decl in self._component_parameters.items()
            if not decl.static
        }

    def with_params(self, pytree: dict) -> "Component":
        """Shallow copy with (possibly per-member) parameter values substituted."""
        clone = copy.copy(self)
        for pname, value in pytree.items():
            setattr(clone, pname, value)
        return clone

    # -- solve --------------------------------------------------------------

    def solve(self, t_current, t_next, inputs):
        """Solve one step.

        Two call styles, mirroring the reference's PyO3 ``solve``
        (``python/component.rs``): pass a ``TimeseriesCollection`` to run
        the component standalone against raw data (State requirements read
        their own series, everything else is treated as exogenous; returns
        a plain ``{name: value}`` dict), or override this method in a
        Python component to receive typed inputs.
        """
        from .timeseries import TimeseriesCollection

        if isinstance(inputs, TimeseriesCollection):
            return self._solve_collection(t_current, t_next, inputs)
        raise NotImplementedError("Subclasses must implement solve()")

    def _solve_collection(self, t_current, t_next, collection):
        from .model.input_state import InputState
        from .state import VariableSource, make_window
        from .spatial import grid_for_type

        builders = {}
        for definition in self.definitions():
            if definition.requirement_type is RequirementType.Output:
                continue
            data = collection.get_data(definition.name)
            if data is None:
                raise KeyError(
                    f"Variable '{definition.name}' not found in collection"
                )
            source = (
                VariableSource.OwnState
                if definition.requirement_type is RequirementType.State
                else VariableSource.Exogenous
            )
            idx = data.time_axis().index_of(t_current)

            def make(data=data, idx=idx, definition=definition, source=source):
                import numpy as _np

                values = _np.asarray(data.values())
                if values.ndim == 1:  # reference-style flat scalar series
                    values = values[:, None]
                return make_window(
                    definition.grid_type,
                    values,
                    idx,
                    t_current,
                    source=source,
                    strategy=data.interpolation_strategy,
                    time_values=data.time_axis().values(),
                    grid=grid_for_type(definition.grid_type),
                )

            builders[definition.name] = make

        ctx = SolveContext(t_current=t_current, t_next=t_next, step_index=0)
        typed = self.Inputs.from_input_state(InputState(builders, t_current))
        outputs, _ = self.solve_ctx(ctx, typed, self.create_initial_state())
        if hasattr(outputs, "to_dict"):
            outputs = outputs.to_dict()
        return dict(outputs)

    # Internal (private) state threading — mirror of ComponentState
    # (component.rs:311-329).  Return a dict of arrays or None.
    def create_initial_state(self):
        return None

    def solve_with_state(self, t_current, t_next, inputs, internal_state):
        """Default: stateless components ignore internal state."""
        return self.solve(t_current, t_next, inputs), internal_state

    # Extended solve for components that need the step index (year loops,
    # interpolation at sub-step times...).  Default dispatches to
    # solve_with_state for backwards compatibility.
    def solve_ctx(self, ctx: SolveContext, inputs, internal_state):
        return self.solve_with_state(ctx.t_current, ctx.t_next, inputs, internal_state)

    # -- doc metadata (rscm-doc-gen parity) ---------------------------------

    @classmethod
    def component_metadata(cls) -> dict:
        def meta(declmap, kind):
            return [
                {
                    "rust_name": field,
                    "variable_name": decl.name,
                    "unit": decl.unit,
                    "grid": _parse_grid(decl.grid).value,
                    "description": decl.description,
                }
                for field, decl in declmap.items()
            ]

        return {
            "name": cls.__name__,
            "tags": list(cls.tags),
            "category": cls.category,
            "inputs": meta(cls._component_inputs, "inputs"),
            "outputs": meta(cls._component_outputs, "outputs"),
            "states": meta(cls._component_states, "states"),
            "parameters": [
                {
                    "name": pname,
                    "default": None if decl.default is REQUIRED else decl.default,
                    "unit": decl.unit,
                    "description": decl.description,
                }
                for pname, decl in cls._component_parameters.items()
            ],
        }

    def __repr__(self):
        params = ", ".join(
            f"{p}={getattr(self, p, None)!r}" for p in self._component_parameters
        )
        return f"{type(self).__name__}({params})"
