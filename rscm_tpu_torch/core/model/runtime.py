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

The checkpoint/serialisation surface is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..spatial import GridType, grid_for_type
from ..state import DeviceWindow, StateValue, VariableSource, make_window
from ..component import RequirementType, SolveContext
from ..timeseries import TimeseriesCollection, VariableType
from .graph import ComponentGraph, NullComponent
from .input_state import InputState
from .types import ReadSpec, WriteSpec

__all__ = ["Model", "prepare_inputs"]


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
