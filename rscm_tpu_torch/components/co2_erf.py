"""
Logarithmic CO2 effective radiative forcing.

Mirror of ``crates/rscm-components/src/components/co2_erf.rs``:

    F = F_2x / ln 2 · ln(1 + ΔC / C0)
"""

from __future__ import annotations

import math

from rscm_tpu_torch.core.component import Component, Input, Output, Parameter
from rscm_tpu_torch.core import xmath as xm

from ._builder import make_builder

__all__ = ["CO2ERF", "CO2ERFBuilder"]


class CO2ERF(Component):
    """CO2 effective radiative forcing from concentration."""

    tags = ("radiative-forcing", "co2", "simple", "stable")
    category = "Radiative Forcing"

    concentration = Input("Atmospheric Concentration|CO2", unit="ppm")
    erf = Output("Effective Radiative Forcing|CO2", unit="W/m^2")

    erf_2xco2 = Parameter(description="Forcing at doubled CO2", unit="W/m^2")
    conc_pi = Parameter(description="Pre-industrial CO2 concentration", unit="ppm")

    def calculate_erf(self, concentration):
        return (
            self.erf_2xco2
            / math.log(2.0)
            * xm.log(1.0 + (concentration - self.conc_pi) / self.conc_pi)
        )

    def solve_ctx(self, ctx, inputs, internal_state):
        concentration = inputs.concentration.get()
        return (self.Outputs(erf=self.calculate_erf(concentration)), internal_state)


CO2ERFBuilder = make_builder(CO2ERF)
