"""
Model: a coupled set of components solved on a common time axis.

Mirror of ``crates/rscm-core/src/model/runtime.rs`` — per timestep the
components are visited in topological order; each component reads its
inputs through windows (with unit conversion / source resolution /
read-side aggregation), solves over the half-open step, and writes outputs
at index **N+1** (applying write-side aggregation).  Solve errors are
reported and skipped, leaving NaN holes, exactly like the reference
(``runtime.rs:493-495``).

Two executors share the single static execution plan:

- the **step-by-step executor** (this module, ``step()``): one member, one
  step at a time, arbitrary Python components.  The collection stays host
  numpy between steps; each component reads it through host windows whose
  values come back as tensors on the run's device (:class:`DeviceWindow`),
  and its outputs are written back to the host at N+1;
- the **year loop** (:mod:`.program`): the whole run as a loop over years
  on batched tensors; ``run()`` takes it when every component can run
  there (``traceable``), as the TPU package's ``run()`` takes its compiled
  ``lax.scan`` program.

Checkpoints (:meth:`Model.checkpoint`, :meth:`Model.restore`) and the
whole-model serialisation (:meth:`Model.to_full_dict`, :meth:`Model.to_toml`)
write the TPU package's JSON and TOML formats, with internal states in
their host layout, so a checkpoint written by either package restores in
the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np
import torch

from ..spatial import GridType, grid_for_type
from ..state import DeviceWindow, StateValue, VariableSource, make_window
from ..component import RequirementType, SolveContext, state_to_host
from ..timeseries import TimeseriesCollection, VariableType
from .graph import ComponentGraph, NullComponent
from .input_state import InputState
from .types import ReadSpec, WriteSpec

__all__ = ["Model", "prepare_inputs"]

#: module prefix of the TPU package's components, and the port's for each
_REFERENCE_PREFIX = ("rscm_tpu.", "rscm_tpu_torch.")


def _listify(obj):
    """Prepare a nested structure for TOML: tuples->lists, drop None values."""
    if isinstance(obj, dict):
        return {k: _listify(v) for k, v in obj.items() if v is not None}
    if isinstance(obj, (list, tuple)):
        return [_listify(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _detomlify(obj):
    return obj


def _encode_state(state):
    """An internal state as JSON values: dicts and lists kept, every leaf
    (numpy, tensor on any device, scalar) as nested lists of numbers."""
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: _encode_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_encode_state(v) for v in state]
    if isinstance(state, torch.Tensor):
        state = state.detach().cpu().numpy()
    return np.asarray(state).tolist()


def _schema_of(state):
    """Keys and leaf shapes of a state, whether its leaves are JSON lists or
    arrays."""
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: _schema_of(v) for k, v in state.items()}
    try:
        arr = np.asarray(state)
        if arr.dtype != object:
            return arr.shape
    except ValueError:
        pass
    return [_schema_of(v) for v in state]


def _decode_state(encoded, template):
    """JSON values in the structure and leaf kinds of ``template`` (a
    host-layout state)."""
    if encoded is None or template is None:
        return template
    if isinstance(template, dict):
        return {k: _decode_state(encoded.get(k), v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        decoded = [_decode_state(e, t) for e, t in zip(encoded, template)]
        return type(template)(decoded) if isinstance(template, tuple) else decoded
    arr = np.asarray(encoded, dtype=np.float64)
    if np.ndim(template):
        return arr
    if isinstance(template, float):
        return float(arr)
    return arr.reshape(np.shape(template))


def _decode_raw(encoded):
    """JSON values in their saved structure (a migration hook's input)."""
    if isinstance(encoded, dict):
        return {k: _decode_raw(v) for k, v in encoded.items()}
    arr = np.asarray(encoded, dtype=np.float64)
    return float(arr) if arr.ndim == 0 else arr


def _transform_dict(t) -> dict:
    return {
        "variable": t.variable,
        "unit": t.unit,
        "source_grid": t.source_grid.value,
        "target_grid": t.target_grid.value,
        "direction": t.direction,
    }


def prepare_inputs(component, input_state: InputState):
    """Adapt an InputState to what the component's solve expects."""
    inputs_cls = getattr(component, "Inputs", None)
    if inputs_cls is not None:
        return inputs_cls.from_input_state(input_state)
    return input_state


class Model:
    """Executable model — see module docstring."""

    def __init__(
        self,
        graph: ComponentGraph,
        initial_node: int,
        collection: TimeseriesCollection,
        time_axis,
        grid_weights: Dict[GridType, list],
        read_transforms: Dict[str, object],
        write_transforms: Dict[str, object],
        unit_conversions: Dict[tuple, float],
        variable_sources: Dict[tuple, str],
    ):
        self.graph = graph
        self.initial_node = initial_node
        self.collection = collection
        self.time_axis = time_axis
        self.time_index = 0
        #: bumped whenever the run changes the model's data or internal
        #: states, so cached copies of them (EnsembleRunner) go stale
        self._state_version = 0
        self.grid_weights = grid_weights
        self.read_transforms = read_transforms
        self.write_transforms = write_transforms
        self.unit_conversions = unit_conversions
        self.variable_sources = variable_sources

        # topological execution (BFS-compatible on chains; see graph.topo_order)
        self.exec_order = graph.topo_order(initial_node)
        self.component_states = {
            node: graph.nodes[node].create_initial_state() for node in graph.node_indices()
        }
        self._plan = self._build_plan()
        self._programs = {}  # year-loop programs by device, built lazily

    # -- static execution plan ---------------------------------------------

    def _grid_obj(self, grid_type: GridType):
        return grid_for_type(grid_type, self.grid_weights.get(grid_type))

    def _build_plan(self):
        """Resolve per-component read specs and per-variable write specs."""
        plan = {}
        for node in self.exec_order:
            component = self.graph.nodes[node]
            comp_name = getattr(component, "component_name", type(component).__name__)
            read_specs = []
            for req in component.inputs():
                if req.requirement_type is RequirementType.EmptyLink:
                    continue
                name = req.name
                factor = self.unit_conversions.get((name, comp_name), 1.0)
                source = self.variable_sources.get((name, comp_name), VariableSource.Exogenous)
                transform = self.read_transforms.get(name)
                aggregation = None
                window_grid = req.grid_type
                if transform is not None and transform.source_grid != window_grid:
                    aggregation = self._grid_obj(transform.source_grid).transform_matrix(
                        self._grid_obj(window_grid)
                    )
                read_specs.append(ReadSpec(name, window_grid, factor, source, aggregation))

            write_specs = {}
            for req in component.outputs():
                name = req.name
                transform = self.write_transforms.get(name)
                if transform is not None:
                    matrix = self._grid_obj(transform.source_grid).transform_matrix(
                        self._grid_obj(transform.target_grid)
                    )
                    write_specs[name] = WriteSpec(
                        name, transform.source_grid, transform.target_grid, matrix
                    )
                else:
                    write_specs[name] = WriteSpec(name, req.grid_type, req.grid_type, None)
            plan[node] = (read_specs, write_specs)
        return plan

    # -- time accessors ------------------------------------------------------

    def current_time(self) -> float:
        return self.time_axis.at(self.time_index)

    def current_time_bounds(self):
        return self.time_axis.at_bounds(self.time_index)

    def finished(self) -> bool:
        return self.time_index == len(self.time_axis) - 1

    # -- step-by-step execution ---------------------------------------------

    def _build_input_state(self, node: int, device) -> InputState:
        read_specs, _ = self._plan[node]
        t = self.current_time()
        idx = self.time_index
        builders = {}
        for spec in read_specs:
            item = self.collection.get_item(spec.var_name)
            if item is None:
                continue
            data = item.data
            per_member = item.variable_type is VariableType.Endogenous

            def make(spec=spec, data=data, per_member=per_member):
                window = make_window(
                    spec.window_grid,
                    data.values(),
                    idx,
                    t,
                    factor=spec.factor,
                    source=spec.source,
                    strategy=data.interpolation_strategy,
                    time_values=data.time_axis().values(),
                    grid=self._grid_obj(spec.window_grid),
                    aggregation=spec.aggregation,
                )
                return DeviceWindow(window, torch.float64, device, per_member)

            builders[spec.var_name] = make
        return InputState(builders, t)

    def _write_outputs(self, node: int, outputs):
        _, write_specs = self._plan[node]
        if hasattr(outputs, "to_dict"):
            outputs = outputs.to_dict()
        for key, value in outputs.items():
            sv = StateValue.wrap(value)
            spec = write_specs.get(key)
            try:
                row = sv.as_array()
                if isinstance(row, torch.Tensor):
                    # a one-member row: drop the member axis
                    row = row.detach().to(torch.float64).cpu().numpy().reshape(-1)
                row = np.asarray(row, dtype=np.float64)
                if spec is not None and spec.matrix is not None:
                    row = row @ spec.matrix
                data = self.collection.get_data(key)
                if data is None:
                    print(f"Failed to set output {key}: unknown variable")
                    continue
                if row.shape[0] != data.grid.size():
                    print(
                        f"Failed to set output {key}: grid mismatch "
                        f"({row.shape[0]} values for {data.grid.grid_name()} storage)"
                    )
                    continue
                data.set_all(self.time_index + 1, row)
            except Exception as e:  # mirror runtime.rs print-and-continue
                print(f"Failed to set output {key}: {e}")

    def _step_component(self, node: int, device):
        component = self.graph.nodes[node]
        if isinstance(component, NullComponent):
            return
        input_state = self._build_input_state(node, device)
        start, end = self.current_time_bounds()
        ctx = SolveContext(start, end, self.time_index)
        try:
            inputs = prepare_inputs(component, input_state)
            outputs, new_state = component.solve_ctx(ctx, inputs, self.component_states[node])
            self.component_states[node] = new_state
        except Exception as e:
            print(f"Solving failed: {e}")
            return
        self._write_outputs(node, outputs)

    def step(self, device=None):
        """Advance one timestep on the step-by-step executor.

        Runs on the CUDA card unless ``device`` names another (the tests
        pass ``"cpu"``); with no card and no device given it raises.
        """
        from ...utils.target import resolve_device

        assert self.time_index < len(self.time_axis) - 1
        dev = resolve_device(device)
        for node in self.exec_order:
            self._step_component(node, dev)
        self.time_index += 1
        self._state_version += 1

    # -- full runs -----------------------------------------------------------

    def _runs_in_loop(self) -> bool:
        """True when every component can run in the year loop (none declares
        ``traceable = False``, as :class:`PythonComponent` does)."""
        return all(
            getattr(self.graph.nodes[node], "traceable", True) for node in self.exec_order
        )

    def run(self, compiled: Optional[bool] = None, device=None):
        """Run to the end of the time axis as a single member in float64.

        ``compiled=None`` (default) takes the year loop when every
        component can run there and steps otherwise; the choice is made
        before running, so a fault of the year loop raises instead of
        falling back.  ``True`` takes the year loop (raising ``TypeError``
        when a component cannot run there); ``False`` steps.  Runs on the
        CUDA card unless ``device`` names another (the tests pass
        ``"cpu"``); with no card and no device given it raises.
        """
        if self.finished():
            return
        from ...utils.target import resolve_device

        dev = resolve_device(device)
        if compiled is None:
            compiled = self._runs_in_loop()
        if compiled:
            self._get_program(dev).run_into_collection(self)
            self.time_index = len(self.time_axis) - 1
            self._state_version += 1
            return
        while not self.finished():
            self.step(dev)

    def _get_program(self, device):
        if device not in self._programs:
            from .program import ModelProgram

            self._programs[device] = ModelProgram(self, device=device)
        return self._programs[device]

    @property
    def program(self):
        """The year-loop program on the default device, the CUDA card
        (built on first access; ``TypeError`` when a component cannot run
        in the loop)."""
        from ...utils.target import resolve_device

        return self._get_program(resolve_device(None))

    # -- results --------------------------------------------------------------

    def timeseries(self) -> TimeseriesCollection:
        """Clone of the collection held by the model."""
        return self.collection.copy()

    # -- checkpoint / restore -------------------------------------------------

    def _host_states(self) -> dict:
        """Every internal state in its host layout (the layout of
        ``create_initial_state``): numpy leaves on the host, without the
        member axis a one-member run on the step-by-step executor leaves,
        Python floats where the initial state has them."""
        out = {}
        for node, state in self.component_states.items():
            if isinstance(state, dict):
                state = state_to_host(state, self.graph.nodes[node].create_initial_state())
            out[node] = state
        return out

    def to_dict(self) -> dict:
        """Whole-model state: collection, time index, component states.

        Mirror of ``Model::checkpoint`` (``runtime.rs:270-282``), enough to
        recreate the run mid-stream, in the TPU package's format.
        """
        return {
            "time_index": self.time_index,
            "time_axis": self.time_axis.to_dict(),
            "collection": self.collection.to_dict(),
            "component_states": {
                str(node): _encode_state(state)
                for node, state in self._host_states().items()
                if state is not None
            },
        }

    def checkpoint(self) -> str:
        return json.dumps(self.to_dict())

    def restore(self, d: dict):
        """Restore collection/time state from a checkpoint dict in place.

        Internal states are validated against each component's *current*
        state schema (keys and leaf shapes) before being adopted: a
        component whose configuration changed between save and restore
        (e.g. a different convolution engine or window size) would
        otherwise compute with a half-restored state.  Components may
        define ``migrate_internal_state(saved)`` to convert a mismatched
        saved state (:class:`OceanCarbon` migrates ring-engine checkpoints
        into the exp-sum layout); without one, a mismatch raises.  Restored
        states are in the host layout; cached year-loop programs are
        dropped and the state version bumped, so an ``EnsembleRunner`` over
        this model gathers its inputs again.
        """
        from ..timeseries import TimeseriesCollection as TC

        templates = self._host_states()
        self.time_index = int(d["time_index"])
        self._state_version += 1
        self.collection = TC.from_dict(d["collection"])
        self.component_states = templates
        for node_str, encoded in d.get("component_states", {}).items():
            node = int(node_str)
            template = templates.get(node)
            if encoded is None or template is None:
                continue
            if _schema_of(encoded) == _schema_of(template):
                self.component_states[node] = _decode_state(encoded, template)
                continue
            component = self.graph.nodes[node]
            name = getattr(component, "component_name", type(component).__name__)
            migrate = getattr(component, "migrate_internal_state", None)
            if migrate is None:
                raise ValueError(
                    f"checkpoint restore: saved internal state of component "
                    f"{name!r} does not match its current schema "
                    f"(saved {_schema_of(encoded)}, current "
                    f"{_schema_of(template)}). The component's configuration "
                    "(e.g. an engine or window-size parameter) changed "
                    "between save and restore; rebuild the model with the "
                    "original configuration."
                )
            migrated = migrate(_decode_raw(encoded))
            if _schema_of(migrated) != _schema_of(template):
                raise ValueError(
                    f"checkpoint restore: {name}.migrate_internal_state "
                    f"produced {_schema_of(migrated)}, but the current schema "
                    f"is {_schema_of(template)}"
                )
            self.component_states[node] = migrated
        self._programs = {}

    # -- full serialisation (component reconstruction) ------------------------

    def to_full_dict(self) -> dict:
        """Complete model state incl. components and the execution graph.

        Equivalent of the reference's serde whole-model serialisation
        (``Model::checkpoint``, typetag'd components), in the TPU package's
        format: enough for :meth:`from_full_dict` to rebuild an identical
        runnable model.  Components are named by their module in this
        package (``rscm_tpu_torch.*``).  A parameter held as a dataclass
        (OceanCarbon's impulse-response forms) is written as a dict of its
        fields, so the MAGICC graph also goes through JSON and TOML, which
        the TPU package's writer refuses.
        """
        from ..schema import AggregatorComponent

        components = []
        for comp in self.graph.nodes:
            if isinstance(comp, NullComponent):
                components.append({"kind": "null"})
            elif isinstance(comp, AggregatorComponent):
                components.append(
                    {
                        "kind": "aggregator",
                        "aggregate_name": comp.aggregate_name,
                        "unit": comp.unit,
                        "grid_type": comp.grid_type.value,
                        "operation": comp.operation.kind,
                        "weights": list(comp.operation.weights)
                        if comp.operation.weights
                        else None,
                        "contributors": list(comp.contributors),
                    }
                )
            else:
                params = {}
                for pname in getattr(comp, "_component_parameters", {}):
                    value = getattr(comp, pname, None)
                    if dataclasses.is_dataclass(value) and not isinstance(value, type):
                        # e.g. OceanCarbon's impulse-response forms, which
                        # the component takes back as a dict of fields
                        value = _listify(dataclasses.asdict(value))
                    elif value is not None and not isinstance(
                        value, (str, bool, int, float, list, tuple)
                    ):
                        value = np.asarray(value).tolist()
                    params[pname] = value
                components.append(
                    {
                        "kind": "component",
                        "class": type(comp).__name__,
                        "module": type(comp).__module__,
                        "params": params,
                    }
                )

        edges = [
            {
                "src": src,
                "dst": dst,
                "name": getattr(payload, "name", ""),
                "unit": getattr(payload, "unit", ""),
                "requirement_type": getattr(
                    payload, "requirement_type", RequirementType.EmptyLink
                ).value,
                "grid_type": getattr(payload, "grid_type", GridType.Scalar).value,
            }
            for src, dst, payload in self.graph.edges
        ]

        return {
            **self.to_dict(),
            "components": components,
            "edges": edges,
            "grid_weights": {gt.value: w for gt, w in self.grid_weights.items()},
            "read_transforms": {
                name: _transform_dict(t) for name, t in self.read_transforms.items()
            },
            "write_transforms": {
                name: _transform_dict(t) for name, t in self.write_transforms.items()
            },
            "unit_conversions": [
                [var, comp, factor]
                for (var, comp), factor in self.unit_conversions.items()
            ],
            "variable_sources": [
                [var, comp, source]
                for (var, comp), source in self.variable_sources.items()
            ],
        }

    @staticmethod
    def from_full_dict(d: dict) -> "Model":
        """Rebuild a model from :meth:`to_full_dict`'s dict, written by this
        package or by the TPU package.  A component module named
        ``rscm_tpu.<path>`` (the TPU package's) is imported as
        ``rscm_tpu_torch.<path>``, so a reference dict loads without
        importing the TPU package; parameter values cross over as they
        are (the port takes the reference's engine names).  The TPU package
        cannot read this package's dicts."""
        import importlib

        from ..component import RequirementDefinition
        from ..schema import AggregateDefinition, AggregateOp, AggregatorComponent
        from ..time_axis import TimeAxis
        from .types import RequiredTransformation

        graph = ComponentGraph()
        for spec in d["components"]:
            if spec["kind"] == "null":
                graph.add_node(NullComponent())
            elif spec["kind"] == "aggregator":
                op = (
                    AggregateOp.weighted(spec["weights"])
                    if spec["operation"] == "Weighted"
                    else AggregateOp(spec["operation"])
                )
                graph.add_node(
                    AggregatorComponent(
                        AggregateDefinition(
                            spec["aggregate_name"],
                            spec["unit"],
                            op,
                            spec["contributors"],
                            GridType(spec["grid_type"]),
                        )
                    )
                )
            else:
                module_name = spec["module"]
                reference, port = _REFERENCE_PREFIX
                if module_name.startswith(reference):
                    module_name = port + module_name[len(reference):]
                module = importlib.import_module(module_name)
                cls = getattr(module, spec["class"])
                graph.add_node(cls(**spec["params"]))

        for edge in d["edges"]:
            graph.add_edge(
                edge["src"],
                edge["dst"],
                RequirementDefinition(
                    edge["name"],
                    edge["unit"],
                    RequirementType(edge["requirement_type"]),
                    GridType(edge["grid_type"]),
                ),
            )

        def parse_transforms(entry):
            return {
                name: RequiredTransformation(
                    t["variable"],
                    t["unit"],
                    GridType(t["source_grid"]),
                    GridType(t["target_grid"]),
                    t["direction"],
                )
                for name, t in entry.items()
            }

        model = Model(
            graph=graph,
            initial_node=0,
            collection=TimeseriesCollection.from_dict(d["collection"]),
            time_axis=TimeAxis.from_dict(d["time_axis"]),
            grid_weights={
                GridType(k): v for k, v in d.get("grid_weights", {}).items()
            },
            read_transforms=parse_transforms(d.get("read_transforms", {})),
            write_transforms=parse_transforms(d.get("write_transforms", {})),
            unit_conversions={
                (var, comp): factor
                for var, comp, factor in d.get("unit_conversions", [])
            },
            variable_sources={
                (var, comp): source
                for var, comp, source in d.get("variable_sources", [])
            },
        )
        model.restore(d)
        return model

    def to_toml(self) -> str:
        """Serialise the model to TOML (mirror of ``python/model.rs:224``)."""
        from ...utils.toml_writer import dumps_toml

        return dumps_toml(_listify(self.to_full_dict()))

    @staticmethod
    def from_toml(text: str) -> "Model":
        import tomllib

        return Model.from_full_dict(_detomlify(tomllib.loads(text)))

    # -- introspection --------------------------------------------------------

    def as_dot(self) -> str:
        """Graphviz dot export (mirror of ``runtime.rs:532-544``)."""
        lines = ["digraph {"]
        for i, component in enumerate(self.graph.nodes):
            label = repr(component).replace("\\", "\\\\").replace('"', '\\"')
            lines.append(f'    {i} [ label = "{label}" ]')
        for src, dst, payload in self.graph.edges:
            name = getattr(payload, "name", "")
            lines.append(f'    {src} -> {dst} [ label = "{name}" ]')
        lines.append("}")
        return "\n".join(lines)

    def debug_info(self, format: str = "rich") -> str:
        """Execution-order and dataflow introspection.

        Mirror of ``model/debug.rs``: execution order, per-component inputs
        with source classification, outputs, grids, transforms, conversions.
        ``format`` is ``"rich"`` (ANSI colours), ``"plain"`` or ``"json"``.
        """
        info = {"execution_order": [], "variables": {}}
        for position, node in enumerate(self.exec_order):
            component = self.graph.nodes[node]
            if isinstance(component, NullComponent):
                continue
            comp_name = getattr(component, "component_name", type(component).__name__)
            read_specs, write_specs = self._plan[node]
            entry = {
                "component": comp_name,
                "position": position,
                "inputs": [
                    {
                        "name": spec.var_name,
                        "source": spec.source,
                        "grid": spec.window_grid.value,
                        "unit_conversion_factor": spec.factor,
                        "read_transform": spec.aggregation is not None,
                    }
                    for spec in read_specs
                ],
                "outputs": [
                    {
                        "name": spec.var_name,
                        "grid": spec.source_grid.value,
                        "storage_grid": spec.storage_grid.value,
                        "write_transform": spec.matrix is not None,
                    }
                    for spec in write_specs.values()
                ],
            }
            info["execution_order"].append(entry)
        for item in self.collection:
            info["variables"][item.name] = {
                "type": item.variable_type.value,
                "grid": item.data.grid.grid_name(),
                "units": item.data.units,
            }
        if format == "json":
            return json.dumps(info, indent=2)

        # "rich" = coloured terminal output (mirror of model/debug.rs with
        # the reference's rich-debug feature); "plain" strips the colours.
        if format == "rich":
            bold, dim, reset = "\033[1m", "\033[2m", "\033[0m"
            cyan, green, yellow, magenta = (
                "\033[36m", "\033[32m", "\033[33m", "\033[35m"
            )
        else:
            bold = dim = reset = cyan = green = yellow = magenta = ""

        source_color = {
            VariableSource.Exogenous: green,
            VariableSource.UpstreamOutput: cyan,
            VariableSource.OwnState: magenta,
        }
        lines = [f"{bold}Model execution order:{reset}"]
        for entry in info["execution_order"]:
            lines.append(f"  {bold}[{entry['position']}] {entry['component']}{reset}")
            for inp in entry["inputs"]:
                extra = []
                if inp["unit_conversion_factor"] != 1.0:
                    extra.append(f"x{inp['unit_conversion_factor']:.6g}")
                if inp["read_transform"]:
                    extra.append("aggregated")
                suffix = f" {yellow}({', '.join(extra)}){reset}" if extra else ""
                color = source_color.get(inp["source"], "")
                lines.append(
                    f"      in:  {inp['name']} "
                    f"[{color}{inp['source']}{reset}, {inp['grid']}]{suffix}"
                )
            for out in entry["outputs"]:
                suffix = (
                    f" {yellow}-> {out['storage_grid']}{reset}"
                    if out["write_transform"]
                    else ""
                )
                lines.append(f"      out: {out['name']} [{out['grid']}]{suffix}")
        lines.append(f"{dim}{len(info['variables'])} variables in collection{reset}")
        return "\n".join(lines)
