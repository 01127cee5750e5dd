"""
ModelBuilder: assemble the component graph, validate it, allocate state.

Faithful functional mirror of ``crates/rscm-core/src/model/builder.rs``:

1. Per component (user insertion order): classify each input's
   :class:`VariableSource` (OwnState for State requirements, UpstreamOutput
   when an earlier component produces it or it is a schema aggregate,
   Exogenous otherwise), verify variable definitions (first definition wins;
   later different-but-compatible units produce read-side conversion
   factors; grid mismatches without a schema are errors), and add graph
   edges producer -> consumer.
2. Cycle check.
3. Schema path: validate the schema, collect read/write grid transforms and
   unit conversions against schema (storage) units/grids, register
   schema-only variables as exogenous, insert
   :class:`~rscm_tpu_torch.core.schema.AggregatorComponent` nodes in topological
   order, then wire pending aggregate dependencies.
4. State variables must have initial values.
5. Allocate the :class:`TimeseriesCollection`: exogenous data is
   interpolated onto the model time axis; endogenous variables get NaN
   arrays with initial values broadcast at index 0.

The build is pure host-side Python; its product (the :class:`Model`) holds
the static execution plan that both the eager and the compiled executors
follow.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..component import RequirementDefinition, RequirementType
from ..errors import (
    GridTypeMismatchError,
    IncompatibleUnitsError,
    MissingInitialValueError,
    SchemaUndefinedInputError,
    SchemaUndefinedOutputError,
    UnitParseError,
    UnsupportedGridTransformationError,
)
from ..schema import AggregatorComponent, VariableSchema
from ..spatial import GridType, grid_for_type
from ..state import VariableSource
from ..time_axis import TimeAxis
from ..timeseries import (
    GridTimeseries,
    TimeseriesCollection,
    VariableType,
)
from ..units import Unit
from .graph import ComponentGraph, NullComponent
from .runtime import Model
from .types import (
    RequiredTransformation,
    TransformDirection,
    UnitConversionInfo,
    VariableDefinition,
)

__all__ = ["ModelBuilder"]


def _component_name(component) -> str:
    return getattr(component, "component_name", type(component).__name__)


def _warn_unset_parameters(component, component_name: str) -> None:
    """Warn at build time about required parameters left ``None``.

    The reference's required serde fields fail at deserialization; here a
    component can be constructed with unset (no-default) parameters, which
    only surfaces at run time as per-step "Solving failed" prints and NaN
    output (mirroring ``runtime.rs:493-495`` print-and-skip).  A build-time
    warning points at the actual mistake without changing run semantics.
    """
    import warnings

    from rscm_tpu_torch.core.component import REQUIRED

    unset = [
        pname
        for pname, decl in getattr(component, "_component_parameters", {}).items()
        if decl.default is REQUIRED and getattr(component, pname, None) is None
    ]
    if unset:
        warnings.warn(
            f"Component '{component_name}' has unset parameters "
            f"{sorted(unset)} (no default, no value provided); its solve "
            "will fail each step and the run will produce NaN for its "
            "outputs.",
            stacklevel=3,
        )


def _check_unit_compatibility(variable, component, schema_unit, component_unit):
    """Mirror of ``builder.rs:347-413``: None when identical, conversion info
    when compatible, raises when incompatible."""
    if schema_unit == component_unit:
        return None
    try:
        parsed_schema = Unit.parse(schema_unit)
    except Exception as e:
        raise UnitParseError(variable, schema_unit, str(e)) from e
    try:
        parsed_component = Unit.parse(component_unit)
    except Exception as e:
        raise UnitParseError(variable, component_unit, str(e)) from e

    if parsed_schema == parsed_component:
        return None
    if not parsed_schema.is_compatible(parsed_component):
        def dim_str(u):
            try:
                return str(u.dimension())
            except Exception:
                return "unknown"

        raise IncompatibleUnitsError(
            variable, schema_unit, component_unit, dim_str(parsed_schema), dim_str(parsed_component)
        )
    factor = parsed_schema.conversion_factor(parsed_component)
    return UnitConversionInfo(variable, component, factor, schema_unit, component_unit)


def _verify_definition(definitions, definition, component_name, existing_owner, has_schema):
    """Mirror of ``model/validation.rs:16-84``."""
    existing = definitions.get(definition.name)
    if existing is not None:
        if existing.unit != definition.unit:
            conversion = _check_unit_compatibility(
                definition.name, component_name, existing.unit, definition.unit
            )
            if not has_schema and existing.grid_type != definition.grid_type:
                raise GridTypeMismatchError(
                    definition.name,
                    existing_owner or "unknown",
                    component_name,
                    str(existing.grid_type),
                    str(definition.grid_type),
                )
            if conversion is not None:
                return conversion
        else:
            if not has_schema and existing.grid_type != definition.grid_type:
                raise GridTypeMismatchError(
                    definition.name,
                    existing_owner or "unknown",
                    component_name,
                    str(existing.grid_type),
                    str(definition.grid_type),
                )
        return None
    definitions[definition.name] = VariableDefinition.from_requirement_definition(definition)
    return None


class ModelBuilder:
    """Builder for a :class:`Model`."""

    def __init__(self):
        self.components: List = []
        self.exogenous_variables = TimeseriesCollection()
        self.initial_values: Dict[str, float] = {}
        self.time_axis: TimeAxis = TimeAxis.from_values(np.arange(2000.0, 2100.0, 1.0))
        self.schema: Optional[VariableSchema] = None
        self.grid_weights: Dict[GridType, list] = {}

    # -- fluent configuration ----------------------------------------------

    def with_component(self, component) -> "ModelBuilder":
        self.components.append(component)
        return self

    # API-compat aliases for the reference's Python surface
    with_rust_component = with_component
    with_py_component = with_component

    def with_exogenous_variable(self, name: str, timeseries: GridTimeseries) -> "ModelBuilder":
        self.exogenous_variables.add_grid_timeseries(name, timeseries, VariableType.Exogenous)
        return self

    def with_exogenous_collection(self, collection: TimeseriesCollection) -> "ModelBuilder":
        self.exogenous_variables.extend(collection)
        return self

    def with_initial_values(self, initial_values: Dict[str, float]) -> "ModelBuilder":
        self.initial_values.update(initial_values)
        return self

    def with_time_axis(self, time_axis: TimeAxis) -> "ModelBuilder":
        self.time_axis = time_axis
        return self

    def with_schema(self, schema: VariableSchema) -> "ModelBuilder":
        self.schema = schema
        return self

    def with_grid_weights(self, grid_type: GridType, weights: list) -> "ModelBuilder":
        if grid_type is GridType.Scalar:
            raise ValueError(
                "Cannot set weights for Scalar grid type (scalars have no regional weights)"
            )
        expected = grid_type.size
        if len(weights) != expected:
            raise ValueError(
                f"Weights length {len(weights)} does not match {grid_type} grid size {expected}"
            )
        total = float(sum(weights))
        if abs(total - 1.0) > 1e-6:
            raise ValueError(f"Weights must sum to 1.0, got {total}")
        self.grid_weights[grid_type] = list(weights)
        return self

    # -- schema validation helpers -----------------------------------------

    def _validate_component_against_schema(
        self, schema, component_name, inputs, outputs, endogenous
    ):
        """Mirror of ``builder.rs:217-339``."""
        transformations = []
        unit_conversions = []

        for output in outputs:
            if not schema.contains(output.name):
                raise SchemaUndefinedOutputError(component_name, output.name, output.unit)
            schema_unit = schema.get_unit(output.name)
            if schema_unit is not None:
                conversion = _check_unit_compatibility(
                    output.name, component_name, schema_unit, output.unit
                )
                if conversion is not None:
                    unit_conversions.append(conversion)
            schema_grid = schema.get_grid_type(output.name)
            if schema_grid is not None and schema_grid != output.grid_type:
                if output.grid_type.can_aggregate_to(schema_grid):
                    transformations.append(
                        RequiredTransformation(
                            output.name, output.unit, output.grid_type, schema_grid,
                            TransformDirection.Write,
                        )
                    )
                else:
                    raise UnsupportedGridTransformationError(
                        output.name, str(output.grid_type), str(schema_grid)
                    )

        for input_def in inputs:
            if input_def.requirement_type is RequirementType.EmptyLink:
                continue
            if not schema.contains(input_def.name) and input_def.name not in endogenous:
                raise SchemaUndefinedInputError(component_name, input_def.name, input_def.unit)
            if schema.contains(input_def.name):
                schema_unit = schema.get_unit(input_def.name)
                if schema_unit is not None:
                    conversion = _check_unit_compatibility(
                        input_def.name, component_name, schema_unit, input_def.unit
                    )
                    if conversion is not None:
                        unit_conversions.append(conversion)
                schema_grid = schema.get_grid_type(input_def.name)
                if schema_grid is not None and schema_grid != input_def.grid_type:
                    if schema_grid.can_aggregate_to(input_def.grid_type):
                        transformations.append(
                            RequiredTransformation(
                                input_def.name, input_def.unit, schema_grid,
                                input_def.grid_type, TransformDirection.Read,
                            )
                        )
                    else:
                        raise UnsupportedGridTransformationError(
                            input_def.name, str(schema_grid), str(input_def.grid_type)
                        )

        return transformations, unit_conversions

    # -- build --------------------------------------------------------------

    def build(self) -> Model:
        graph = ComponentGraph()
        endogenous: Dict[str, int] = {}
        exogenous: List[str] = []
        definitions: Dict[str, VariableDefinition] = {}
        variable_owners: Dict[str, str] = {}
        unit_conversions: List[UnitConversionInfo] = []
        variable_sources: Dict[tuple, str] = {}
        initial_node = graph.add_node(NullComponent())

        pending_aggregate_deps = []
        aggregate_names = set(self.schema.aggregates) if self.schema else set()
        has_schema = self.schema is not None

        # optional component hook: axis-dependent validation and static
        # sizing (e.g. SeaLevelRise requires a uniform axis for its
        # step-indexed IRF history and bakes the step size into its
        # static convolution kernels)
        for component in self.components:
            hook = getattr(component, "validate_time_axis", None)
            if hook is not None:
                hook(self.time_axis)

        for component in self.components:
            node = graph.add_node(component)
            has_dependencies = False
            component_name = _component_name(component)
            _warn_unset_parameters(component, component_name)

            requires = component.inputs()
            provides = component.outputs()

            # variable source classification (builder.rs:478-496)
            for requirement in requires:
                if requirement.requirement_type is RequirementType.EmptyLink:
                    continue
                if requirement.requirement_type is RequirementType.State:
                    source = VariableSource.OwnState
                elif requirement.name in endogenous:
                    source = VariableSource.UpstreamOutput
                elif requirement.name in aggregate_names:
                    source = VariableSource.UpstreamOutput
                else:
                    source = VariableSource.Exogenous
                variable_sources[(requirement.name, component_name)] = source

            for requirement in requires:
                conversion = _verify_definition(
                    definitions,
                    requirement,
                    component_name,
                    variable_owners.get(requirement.name),
                    has_schema,
                )
                if conversion is not None:
                    unit_conversions.append(conversion)

                if requirement.name in endogenous:
                    graph.add_edge(endogenous[requirement.name], node, requirement)
                    has_dependencies = True
                elif requirement.name in aggregate_names:
                    pending_aggregate_deps.append((node, requirement.name, requirement))
                    has_dependencies = True
                else:
                    if requirement.name not in exogenous:
                        exogenous.append(requirement.name)

            if not has_dependencies:
                graph.add_edge(
                    initial_node,
                    node,
                    RequirementDefinition("", "", RequirementType.EmptyLink),
                )

            for requirement in provides:
                conversion = _verify_definition(
                    definitions,
                    requirement,
                    component_name,
                    variable_owners.get(requirement.name),
                    has_schema,
                )
                if conversion is not None:
                    unit_conversions.append(conversion)

                variable_owners[requirement.name] = component_name

                existing = endogenous.get(requirement.name)
                if existing is not None:
                    graph.add_edge(existing, node, requirement)
                endogenous[requirement.name] = node

        graph.check_acyclic()

        all_transformations: List[RequiredTransformation] = []

        if self.schema is not None:
            schema = self.schema
            schema.validate()

            for component in self.components:
                component_name = _component_name(component)
                transforms, conversions = self._validate_component_against_schema(
                    schema, component_name, component.inputs(), component.outputs(), endogenous
                )
                all_transformations.extend(transforms)
                unit_conversions.extend(conversions)

            # schema-only variables become exogenous inputs (builder.rs:600-629)
            for name, var_def in schema.variables.items():
                if name not in definitions:
                    try:
                        parsed = Unit.parse(var_def.unit)
                    except Exception:
                        parsed = None
                    definitions[name] = VariableDefinition(
                        name, var_def.unit, parsed, var_def.grid_type, RequirementType.Input
                    )
                    exogenous.append(name)
                else:
                    definition = definitions[name]
                    if definition.grid_type != var_def.grid_type:
                        definition.grid_type = var_def.grid_type
                        if name not in endogenous:
                            exogenous.append(name)

            # insert aggregator components in topological order (builder.rs:631-700)
            for agg_name in schema.topological_order_aggregates():
                agg_def = schema.get_aggregate(agg_name)
                aggregator = AggregatorComponent.from_definition(agg_def)
                agg_node = graph.add_node(aggregator)
                variable_owners[agg_name] = aggregator.component_name

                has_dependencies = False
                for contributor in agg_def.contributors:
                    if contributor in endogenous:
                        graph.add_edge(
                            endogenous[contributor],
                            agg_node,
                            RequirementDefinition(
                                contributor, agg_def.unit, RequirementType.Input,
                                agg_def.grid_type,
                            ),
                        )
                        has_dependencies = True
                if not has_dependencies:
                    graph.add_edge(
                        initial_node,
                        agg_node,
                        RequirementDefinition("", "", RequirementType.EmptyLink),
                    )
                endogenous[agg_name] = agg_node
                try:
                    parsed = Unit.parse(agg_def.unit)
                except Exception:
                    parsed = None
                definitions[agg_name] = VariableDefinition(
                    agg_name, agg_def.unit, parsed, agg_def.grid_type, RequirementType.Output
                )

            for component_node, var_name, requirement in pending_aggregate_deps:
                if var_name in endogenous:
                    graph.add_edge(endogenous[var_name], component_node, requirement)

        # initial-value check for State variables (builder.rs:704-717)
        for name, definition in definitions.items():
            if (
                definition.requirement_type is RequirementType.State
                and name not in self.initial_values
            ):
                raise MissingInitialValueError(name, variable_owners.get(name, "unknown"))

        read_transforms: Dict[str, RequiredTransformation] = {}
        write_transforms: Dict[str, RequiredTransformation] = {}
        for transform in all_transformations:
            if transform.direction == TransformDirection.Read:
                read_transforms[transform.variable] = transform
            else:
                write_transforms[transform.variable] = transform

        # allocate the collection (builder.rs:736-830)
        collection = TimeseriesCollection()
        for name, definition in definitions.items():
            var_type = (
                VariableType.Endogenous if name in endogenous else VariableType.Exogenous
            )
            storage_grid = (
                write_transforms[name].target_grid
                if name in write_transforms
                else definition.grid_type
            )
            exo_data = (
                self.exogenous_variables.get_data(name) if name in exogenous else None
            )
            initial_val = self.initial_values.get(name)

            if exo_data is not None and exo_data.grid.grid_type == storage_grid:
                collection.add_grid_timeseries(
                    name, exo_data.copy().interpolate_into(self.time_axis), var_type
                )
            else:
                grid = grid_for_type(storage_grid, self.grid_weights.get(storage_grid))
                ts = GridTimeseries.new_empty(self.time_axis, grid, definition.unit)
                if initial_val is not None:
                    # broadcast initial value to all regions (builder.rs:797-826)
                    ts.set_all(0, [float(initial_val)] * grid.size())
                collection.add_grid_timeseries(name, ts, var_type)

        unit_conversion_map = {
            (info.variable, info.component): info.factor for info in unit_conversions
        }

        model = Model(
            graph=graph,
            initial_node=initial_node,
            collection=collection,
            time_axis=self.time_axis,
            grid_weights=dict(self.grid_weights),
            read_transforms=read_transforms,
            write_transforms=write_transforms,
            unit_conversions=unit_conversion_map,
            variable_sources=variable_sources,
        )
        return model
