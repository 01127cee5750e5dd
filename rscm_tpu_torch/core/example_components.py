"""
Example components used in tests and documentation.

Mirror of ``crates/rscm-core/src/example_components.rs``.
"""

from __future__ import annotations

from .component import Component, Input, Output, Parameter

__all__ = ["TestComponent", "TestComponentBuilder"]


class TestComponent(Component, register=False):
    """Emissions x conversion factor -> concentrations."""

    __test__ = False  # not a pytest class

    emissions_co2 = Input("Emissions|CO2", unit="GtCO2")
    concentration_co2 = Output("Concentrations|CO2", unit="ppm")

    conversion_factor = Parameter(description="Emissions -> concentration factor")

    def calculate_concentration(self, emissions):
        return emissions * self.conversion_factor

    def solve_ctx(self, ctx, inputs, internal_state):
        emissions = inputs.emissions_co2.get()
        return (
            self.Outputs(concentration_co2=self.calculate_concentration(emissions)),
            internal_state,
        )


class TestComponentBuilder:
    __test__ = False  # not a pytest class

    def __init__(self, parameters: dict):
        self._parameters = dict(parameters)

    @classmethod
    def from_parameters(cls, parameters: dict) -> "TestComponentBuilder":
        # validate eagerly, like serde deserialisation in the reference
        TestComponent.from_parameters(parameters)
        return cls(parameters)

    def build(self) -> TestComponent:
        return TestComponent.from_parameters(self._parameters)
