"""
Variable schema: first-class variable declarations + aggregate variables.

Mirror of ``crates/rscm-core/src/schema.rs``:

- :class:`VariableSchema` declares all model variables (name/unit/grid) and
  aggregates (Sum / Mean / Weighted over contributor variables with
  NaN-skipping).
- ``validate()`` checks contributor existence, unit & grid consistency,
  weight counts, and aggregate-on-aggregate cycles.
- Aggregates execute as auto-inserted virtual :class:`AggregatorComponent`
  nodes in the model graph, topologically ordered so chained aggregates
  resolve correctly.

In the batched year loop an aggregator is a small masked reduction over
its contributors, per member.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .component import RequirementDefinition, RequirementType
from .errors import SchemaValidationError
from .spatial import GridType
from .state import FourBoxSlice, HemisphericSlice, StateValue, is_traced

__all__ = [
    "AggregateOp",
    "SchemaVariableDefinition",
    "AggregateDefinition",
    "VariableSchema",
    "AggregatorComponent",
    "compute_aggregate",
]


@dataclass(frozen=True)
class AggregateOp:
    """Sum / Mean / Weighted aggregate operation."""

    kind: str  # "Sum" | "Mean" | "Weighted"
    weights: Optional[tuple] = None

    SUM = None  # set below
    MEAN = None

    @staticmethod
    def sum() -> "AggregateOp":
        return AggregateOp("Sum")

    @staticmethod
    def mean() -> "AggregateOp":
        return AggregateOp("Mean")

    @staticmethod
    def weighted(weights) -> "AggregateOp":
        return AggregateOp("Weighted", tuple(float(w) for w in weights))

    @property
    def name(self) -> str:
        return self.kind


AggregateOp.SUM = AggregateOp.sum()
AggregateOp.MEAN = AggregateOp.mean()


@dataclass
class SchemaVariableDefinition:
    name: str
    unit: str
    grid_type: GridType = GridType.Scalar


@dataclass
class AggregateDefinition:
    name: str
    unit: str
    operation: AggregateOp
    contributors: List[str] = field(default_factory=list)
    grid_type: GridType = GridType.Scalar

    @property
    def operation_type(self) -> str:
        return self.operation.kind

    @property
    def weights(self):
        return list(self.operation.weights) if self.operation.weights else None


def compute_aggregate(contributors, op: AggregateOp):
    """NaN-skipping aggregate (mirror of ``schema.rs`` ``compute_aggregate``).

    Works on host floats (returns float, NaN when all contributors are NaN)
    and on tensors batched over members (branch-free masking per member).
    """
    if any(is_traced(v) for v in contributors):
        import torch

        ref = next(v for v in contributors if is_traced(v))
        vals = torch.stack(
            [torch.as_tensor(v, dtype=ref.dtype, device=ref.device) for v in contributors]
        )  # (n_contributors, members...)
        valid = ~torch.isnan(vals)
        zeroed = torch.where(valid, vals, torch.zeros_like(vals))
        any_valid = valid.any(0)
        if op.kind == "Sum":
            out = zeroed.sum(0)
        elif op.kind == "Mean":
            out = zeroed.sum(0) / valid.sum(0).clamp(min=1)
        elif op.kind == "Weighted":
            w = torch.as_tensor(op.weights, dtype=vals.dtype, device=vals.device)
            w = w.reshape((-1,) + (1,) * (vals.dim() - 1))
            out = torch.where(valid, vals * w, torch.zeros_like(vals)).sum(0)
        else:
            raise ValueError(f"Unknown aggregate op {op.kind}")
        return torch.where(any_valid, out, torch.full_like(out, float("nan")))

    vals = [float(v) for v in contributors]
    valid = [v for v in vals if not np.isnan(v)]
    if op.kind == "Sum":
        return float(sum(valid)) if valid else float("nan")
    if op.kind == "Mean":
        return float(sum(valid) / len(valid)) if valid else float("nan")
    if op.kind == "Weighted":
        pairs = [(v, w) for v, w in zip(vals, op.weights) if not np.isnan(v)]
        return float(sum(v * w for v, w in pairs)) if pairs else float("nan")
    raise ValueError(f"Unknown aggregate op {op.kind}")


class VariableSchema:
    """Complete variable schema for a model."""

    def __init__(self):
        self.variables: Dict[str, SchemaVariableDefinition] = {}
        self.aggregates: Dict[str, AggregateDefinition] = {}

    # -- construction (both fluent and imperative APIs) ---------------------

    def add_variable(self, name: str, unit: str, grid_type: Optional[GridType] = None):
        self.variables[name] = SchemaVariableDefinition(
            name, unit, grid_type or GridType.Scalar
        )

    def add_aggregate(
        self,
        name: str,
        unit: str,
        operation,
        contributors: List[str],
        weights=None,
        grid_type: Optional[GridType] = None,
    ):
        if isinstance(operation, str):
            if operation == "Weighted":
                if weights is None:
                    raise ValueError("Weighted aggregation weights must be provided")
                operation = AggregateOp.weighted(weights)
            elif operation in ("Sum", "Mean"):
                operation = AggregateOp(operation)
            else:
                raise ValueError(
                    f"Unknown operation for aggregate: {operation}. "
                    f'Must be "Sum", "Mean", or "Weighted"'
                )
        self.aggregates[name] = AggregateDefinition(
            name, unit, operation, list(contributors), grid_type or GridType.Scalar
        )

    def variable(self, name: str, unit: str) -> "VariableSchema":
        self.add_variable(name, unit)
        return self

    def variable_with_grid(self, name: str, unit: str, grid_type: GridType) -> "VariableSchema":
        self.add_variable(name, unit, grid_type)
        return self

    # -- queries ------------------------------------------------------------

    def contains(self, name: str) -> bool:
        return name in self.variables or name in self.aggregates

    def get_variable(self, name: str):
        return self.variables.get(name)

    def get_aggregate(self, name: str):
        return self.aggregates.get(name)

    def get_unit(self, name: str):
        if name in self.variables:
            return self.variables[name].unit
        if name in self.aggregates:
            return self.aggregates[name].unit
        return None

    def get_grid_type(self, name: str):
        if name in self.variables:
            return self.variables[name].grid_type
        if name in self.aggregates:
            return self.aggregates[name].grid_type
        return None

    # -- validation ---------------------------------------------------------

    def validate(self):
        for agg_name, agg_def in self.aggregates.items():
            for contributor in agg_def.contributors:
                if not self.contains(contributor):
                    raise SchemaValidationError(
                        f"Aggregate '{agg_name}': Undefined contributor "
                        f"'{contributor}'"
                    )
                c_unit = self.get_unit(contributor)
                if c_unit is not None and c_unit != agg_def.unit:
                    raise SchemaValidationError(
                        f"Unit mismatch in aggregate '{agg_name}': contributor "
                        f"'{contributor}' has unit '{c_unit}' but aggregate has "
                        f"unit '{agg_def.unit}'"
                    )
                c_grid = self.get_grid_type(contributor)
                if c_grid is not None and c_grid != agg_def.grid_type:
                    raise SchemaValidationError(
                        f"Grid type mismatch in aggregate '{agg_name}': contributor "
                        f"'{contributor}' is {c_grid} but aggregate is "
                        f"{agg_def.grid_type}"
                    )
            if agg_def.operation.kind == "Weighted":
                if agg_def.operation.weights is None:
                    raise SchemaValidationError(
                        f"Aggregate '{agg_name}': Weighted operation "
                        "requires weights"
                    )
                if len(agg_def.operation.weights) != len(agg_def.contributors):
                    raise SchemaValidationError(
                        f"Weight count mismatch in aggregate '{agg_name}': "
                        f"{len(agg_def.operation.weights)} weights for "
                        f"{len(agg_def.contributors)} contributors"
                    )
        self._check_circular_dependencies()

    def _check_circular_dependencies(self):
        visited = set()

        def dfs(name, path):
            if name in path:
                cycle = " -> ".join(list(path) + [name])
                raise SchemaValidationError(
                    f"Circular dependency between aggregates: {cycle}"
                )
            if name in visited:
                return
            visited.add(name)
            agg = self.aggregates.get(name)
            if agg is None:
                return
            path.append(name)
            for contributor in agg.contributors:
                if contributor in self.aggregates:
                    dfs(contributor, path)
            path.pop()

        for agg_name in self.aggregates:
            dfs(agg_name, [])

    def topological_order_aggregates(self) -> List[str]:
        """Dependency order with the reference's reverse-alphabetical
        tie-breaking (``schema.rs:482``: sorted queue popped from the back)."""
        import bisect

        in_degree = {name: 0 for name in self.aggregates}
        dependents = {name: [] for name in self.aggregates}
        for name, agg in self.aggregates.items():
            for contributor in agg.contributors:
                if contributor in self.aggregates:
                    in_degree[name] += 1
                    dependents[contributor].append(name)

        queue = sorted(n for n, d in in_degree.items() if d == 0)
        result = []
        while queue:
            name = queue.pop()  # last element — reverse-alphabetical pop
            result.append(name)
            for dep in dependents[name]:
                in_degree[dep] -= 1
                if in_degree[dep] == 0:
                    bisect.insort(queue, dep)
        return result

    def __repr__(self):
        return (
            f"VariableSchema(variables={sorted(self.variables)}, "
            f"aggregates={sorted(self.aggregates)})"
        )


class AggregatorComponent:
    """Virtual component computing one aggregate variable.

    Mirror of ``schema.rs:822-849``: reads each contributor with
    upstream-output semantics (at_end falling back to at_start) and writes
    the NaN-skipping aggregate.
    """

    def __init__(self, definition: AggregateDefinition):
        self.aggregate_name = definition.name
        self.unit = definition.unit
        self.grid_type = definition.grid_type
        self.operation = definition.operation
        self.contributors = list(definition.contributors)

    @staticmethod
    def from_definition(definition: AggregateDefinition) -> "AggregatorComponent":
        return AggregatorComponent(definition)

    @property
    def component_name(self) -> str:
        return f"Aggregator:{self.aggregate_name}"

    def definitions(self):
        defs = [
            RequirementDefinition(c, self.unit, RequirementType.Input, self.grid_type)
            for c in self.contributors
        ]
        defs.append(
            RequirementDefinition(
                self.aggregate_name, self.unit, RequirementType.Output, self.grid_type
            )
        )
        return defs

    def inputs(self):
        return [d for d in self.definitions() if d.requirement_type is RequirementType.Input]

    def input_names(self):
        return [d.name for d in self.inputs()]

    def outputs(self):
        return [d for d in self.definitions() if d.requirement_type is RequirementType.Output]

    def output_names(self):
        return [d.name for d in self.outputs()]

    def param_pytree(self):
        return {}

    def with_params(self, pytree):
        return self

    def create_initial_state(self):
        return None

    def solve_ctx(self, ctx, input_state, internal_state):
        out = {}
        if self.grid_type is GridType.Scalar:
            values = []
            for name in self.contributors:
                w = input_state.get_window(name)
                end = w.at_end()
                values.append(w.at_start() if end is None else end)
            out[self.aggregate_name] = StateValue.scalar(
                compute_aggregate(values, self.operation)
            )
        else:
            size = self.grid_type.size
            per_region = [[] for _ in range(size)]
            for name in self.contributors:
                w = input_state.get_window(name)
                vals = w.at_end_all()
                if vals is None:
                    vals = w.at_start_all()
                for i, v in enumerate(vals):
                    per_region[i].append(v)
            agg = [compute_aggregate(vals, self.operation) for vals in per_region]
            if self.grid_type is GridType.FourBox:
                out[self.aggregate_name] = StateValue.four_box(FourBoxSlice.from_array(agg))
            else:
                out[self.aggregate_name] = StateValue.hemispheric(
                    HemisphericSlice.from_array(agg)
                )
        return out, internal_state

    def __repr__(self):
        return f"Aggregator:{self.aggregate_name}"
