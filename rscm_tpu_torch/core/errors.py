"""
Error types for rscm_tpu_torch.

Mirrors the error surface of the reference implementation
(``crates/rscm-core/src/errors.rs:5-169``): rich, actionable build-time
diagnostics are part of the product surface.  All errors derive from
:class:`RSCMError`.
"""

from __future__ import annotations


class RSCMError(ValueError):
    """Base class for all rscm_tpu_torch errors.

    Subclasses ``ValueError`` because the reference's PyO3 layer maps every
    engine error to ``ValueError`` — code written against the reference
    catches ``ValueError``.
    """


class ExtrapolationError(RSCMError):
    """Requested time is outside the interpolation domain and extrapolation is off.

    Message format follows ``errors.rs`` ExtrapolationNotAllowed.
    """

    def __init__(self, target: float, direction: str, bound: float):
        self.target = target
        self.direction = direction
        self.bound = bound
        super().__init__(
            f"Extrapolation is not allowed. Target={float(target)}, "
            f"{direction} interpolation range={float(bound)}"
        )


class UnitParseError(RSCMError):
    def __init__(self, variable: str, unit_string: str, details: str):
        self.variable = variable
        self.unit_string = unit_string
        self.details = details
        super().__init__(
            f"Could not parse unit '{unit_string}' for variable '{variable}': {details}"
        )


class IncompatibleUnitsError(RSCMError):
    def __init__(self, variable: str, unit1: str, unit2: str, dim1: str, dim2: str):
        self.variable = variable
        self.unit1 = unit1
        self.unit2 = unit2
        super().__init__(
            f"Incompatible units for variable '{variable}': "
            f"'{unit1}' (dimension {dim1}) vs '{unit2}' (dimension {dim2}). "
            f"Units must have the same physical dimensions to be convertible."
        )


class UnsupportedGridTransformationError(RSCMError):
    def __init__(self, variable: str, source_grid: str, target_grid: str):
        self.variable = variable
        self.source_grid = source_grid
        self.target_grid = target_grid
        super().__init__(
            f"Unsupported grid transformation for variable '{variable}': "
            f"cannot transform from {source_grid} to {target_grid}. "
            f"Automatic transformations only "
            f"aggregate fine -> coarse (FourBox -> Hemispheric/Scalar, "
            f"Hemispheric -> Scalar); disaggregation requires an explicit component."
        )


class GridTypeMismatchError(RSCMError):
    def __init__(
        self,
        variable: str,
        producer_component: str,
        consumer_component: str,
        producer_grid: str,
        consumer_grid: str,
    ):
        self.variable = variable
        super().__init__(
            f"Grid type mismatch for variable '{variable}': produced by "
            f"'{producer_component}' on {producer_grid} grid but consumed by "
            f"'{consumer_component}' on {consumer_grid} grid. Add a schema to "
            f"enable automatic aggregation, or align the component grids."
        )


class GridOutputMismatchError(RSCMError):
    def __init__(self, variable: str, expected_grid: str, component_grid: str):
        self.variable = variable
        super().__init__(
            f"Grid mismatch writing output '{variable}': collection stores "
            f"{expected_grid} but component produced {component_grid}."
        )


class CircularDependencyError(RSCMError):
    def __init__(self, detail: str = ""):
        super().__init__(
            "Circular dependency detected in the component graph." + (f" {detail}" if detail else "")
        )


class MissingInitialValueError(RSCMError):
    def __init__(self, variable: str, component: str):
        self.variable = variable
        self.component = component
        super().__init__(
            f"Missing initial value for state variable '{variable}' "
            f"(owned by component '{component}'). Provide one via "
            f"ModelBuilder.with_initial_values({{'{variable}': ...}})."
        )


class SchemaUndefinedInputError(RSCMError):
    def __init__(self, component: str, variable: str, unit: str):
        super().__init__(
            f"Component '{component}' requires input '{variable}' ({unit}) "
            f"which is not defined in the schema and not produced by any component."
        )


class SchemaUndefinedOutputError(RSCMError):
    def __init__(self, component: str, variable: str, unit: str):
        super().__init__(
            f"Component '{component}' produces output '{variable}' ({unit}) "
            f"which is not defined in the schema."
        )


class SchemaValidationError(RSCMError):
    """Schema-level validation failure (aggregates, weights, cycles...)."""


class SolveError(RSCMError):
    """A component solve failed at runtime."""
