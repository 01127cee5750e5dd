"""
Model: a coupled set of components solved on a common time axis.

Mirror of ``crates/rscm-core/src/model/runtime.rs`` — per timestep the
components are visited in topological order; each component reads its
inputs through windows (with unit conversion / source resolution /
read-side aggregation), solves over the half-open step, and writes outputs
at index **N+1** (applying write-side aggregation).

The port runs a model through one executor, the batched year loop of
:mod:`.program` (``run()`` runs it for a single member).  The TPU package's
eager host executor (``run(compiled=False)``, ``step()``) and its
checkpoint/serialisation surface are not ported yet.
"""

from __future__ import annotations

from typing import Dict

from ..spatial import GridType, grid_for_type
from ..state import VariableSource
from ..component import RequirementType
from ..timeseries import TimeseriesCollection
from .graph import ComponentGraph
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

    # -- full runs -----------------------------------------------------------

    def run(self, device=None):
        """Run to the end of the time axis as a single member in float64 and
        write the results into the collection.

        Runs on the CUDA card unless ``device`` names another (the tests
        pass ``"cpu"``); with no card and no device given it raises.
        """
        if self.finished():
            return
        from ...utils.target import resolve_device
        from .program import ModelProgram

        ModelProgram(self, device=resolve_device(device)).run_into_collection(self)
        self.time_index = len(self.time_axis) - 1
        self._state_version += 1

    # -- results --------------------------------------------------------------

    def timeseries(self) -> TimeseriesCollection:
        """Clone of the collection held by the model."""
        return self.collection.copy()
