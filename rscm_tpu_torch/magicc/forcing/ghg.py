"""
CO2/CH4/N2O radiative forcing — IPCCTAR and OLBL (Etminan/Meinshausen)
methods with band overlaps and ERF rapid-adjustment scaling.

Mirror of ``crates/rscm-magicc/src/forcing/ghg.rs:66-291`` and
``src/parameters/ghg_forcing.rs`` (MAGICC7 defaults).
"""

from __future__ import annotations

import math

from rscm_tpu_torch.components._builder import make_builder
from rscm_tpu_torch.core import xmath as xm
from rscm_tpu_torch.core.component import Component, Input, Output, Parameter

__all__ = ["ForcingMethod", "GhgForcing", "GhgForcingBuilder"]

LN2 = math.log(2.0)


class ForcingMethod:
    Ipcctar = "Ipcctar"
    Olbl = "Olbl"


def _overlap_f(ch4_ppb, n2o_ppb):
    """CH4/N2O band overlap term (ghg.rs:53-57, IPCC TAR Table 6.2)."""
    mn = ch4_ppb * n2o_ppb
    return 0.47 * xm.log(
        1.0 + 2.01e-5 * mn**0.75 + 5.31e-15 * ch4_ppb * mn**1.52
    )


class GhgForcing(Component):
    """Greenhouse-gas radiative forcing from concentrations."""

    tags = ("forcing", "ghg", "co2", "ch4", "n2o", "magicc")
    category = "Radiative Forcing"

    co2_concentration = Input("Atmospheric Concentration|CO2", unit="ppm")
    ch4_concentration = Input("Atmospheric Concentration|CH4", unit="ppb")
    n2o_concentration = Input("Atmospheric Concentration|N2O", unit="ppb")
    co2_erf = Output("Effective Radiative Forcing|CO2", unit="W/m^2")
    ch4_erf = Output("Effective Radiative Forcing|CH4", unit="W/m^2")
    n2o_erf = Output("Effective Radiative Forcing|N2O", unit="W/m^2")

    method = Parameter(default=ForcingMethod.Olbl, static=True)
    co2_pi = Parameter(default=278.0, unit="ppm")
    ch4_pi = Parameter(default=722.0, unit="ppb")
    n2o_pi = Parameter(default=270.0, unit="ppb")
    delq2xco2 = Parameter(default=3.71, unit="W/m^2")
    ch4_radeff = Parameter(default=0.036)
    n2o_radeff = Parameter(default=0.12)
    olbl_co2_a1 = Parameter(default=-2.4785e-7)
    olbl_co2_b1 = Parameter(default=7.5906e-4)
    olbl_co2_c1 = Parameter(default=-2.1492e-3)
    olbl_co2_d1 = Parameter(default=5.2)
    olbl_ch4_a3 = Parameter(default=-8.9603e-5)
    olbl_ch4_b3 = Parameter(default=-1.2462e-4)
    olbl_ch4_d3 = Parameter(default=0.045)
    olbl_n2o_a2 = Parameter(default=-3.4197e-4)
    olbl_n2o_b2 = Parameter(default=2.5455e-4)
    olbl_n2o_c2 = Parameter(default=-2.4357e-4)
    olbl_n2o_d2 = Parameter(default=0.14)
    adjust_co2 = Parameter(default=1.05)
    adjust_ch4 = Parameter(default=0.86)
    adjust_n2o = Parameter(default=1.0)

    # -- per-method formulas (ghg.rs:87-157) --------------------------------

    def _co2_ipcctar(self, co2):
        return (self.delq2xco2 / LN2) * xm.log(co2 / self.co2_pi)

    def _ch4_ipcctar(self, ch4, _n2o):
        direct = self.ch4_radeff * (xm.sqrt(ch4) - xm.sqrt(self.ch4_pi))
        overlap = _overlap_f(ch4, self.n2o_pi) - _overlap_f(self.ch4_pi, self.n2o_pi)
        return direct - overlap

    def _n2o_ipcctar(self, _ch4, n2o):
        direct = self.n2o_radeff * (xm.sqrt(n2o) - xm.sqrt(self.n2o_pi))
        overlap = _overlap_f(self.ch4_pi, n2o) - _overlap_f(self.ch4_pi, self.n2o_pi)
        return direct - overlap

    def _co2_olbl(self, co2, n2o):
        co2_pi = self.co2_pi
        delta_co2 = co2 - co2_pi
        n2o_overlap = self.olbl_co2_c1 * xm.sqrt(n2o)
        c_max = co2_pi - self.olbl_co2_b1 / (2.0 * self.olbl_co2_a1)

        alpha_hi = (
            -self.olbl_co2_b1 * self.olbl_co2_b1 / (4.0 * self.olbl_co2_a1)
            + self.olbl_co2_d1
            + n2o_overlap
        )
        alpha_lo = self.olbl_co2_d1 + n2o_overlap
        alpha_mid = (
            self.olbl_co2_a1 * delta_co2 * delta_co2
            + self.olbl_co2_b1 * delta_co2
            + self.olbl_co2_d1
            + n2o_overlap
        )
        alpha = xm.where(co2 >= c_max, alpha_hi, xm.where(co2 <= co2_pi, alpha_lo, alpha_mid))
        return alpha * xm.log(co2 / co2_pi)

    def _ch4_olbl(self, ch4, n2o):
        coeff = (
            self.olbl_ch4_a3 * xm.sqrt(ch4)
            + self.olbl_ch4_b3 * xm.sqrt(n2o)
            + self.olbl_ch4_d3
        )
        return coeff * (xm.sqrt(ch4) - xm.sqrt(self.ch4_pi))

    def _n2o_olbl(self, co2, ch4, n2o):
        coeff = (
            self.olbl_n2o_a2 * xm.sqrt(co2)
            + self.olbl_n2o_b2 * xm.sqrt(n2o)
            + self.olbl_n2o_c2 * xm.sqrt(ch4)
            + self.olbl_n2o_d2
        )
        return coeff * (xm.sqrt(n2o) - xm.sqrt(self.n2o_pi))

    # -- public calculation API (ghg.rs:59-84,160-180) ----------------------

    def calculate_co2_forcing(self, co2, n2o):
        if self.method == ForcingMethod.Ipcctar:
            return self._co2_ipcctar(co2)
        return self._co2_olbl(co2, n2o)

    def calculate_ch4_forcing(self, ch4, n2o):
        if self.method == ForcingMethod.Ipcctar:
            return self._ch4_ipcctar(ch4, n2o)
        return self._ch4_olbl(ch4, n2o)

    def calculate_n2o_forcing(self, co2, ch4, n2o):
        if self.method == ForcingMethod.Ipcctar:
            return self._n2o_ipcctar(ch4, n2o)
        return self._n2o_olbl(co2, ch4, n2o)

    def calculate_forcings(self, co2, ch4, n2o):
        return (
            self.calculate_co2_forcing(co2, n2o) * self.adjust_co2,
            self.calculate_ch4_forcing(ch4, n2o) * self.adjust_ch4,
            self.calculate_n2o_forcing(co2, ch4, n2o) * self.adjust_n2o,
        )

    def solve_ctx(self, ctx, inputs, internal_state):
        co2 = inputs.co2_concentration.get()
        ch4 = inputs.ch4_concentration.get()
        n2o = inputs.n2o_concentration.get()
        co2_erf, ch4_erf, n2o_erf = self.calculate_forcings(co2, ch4, n2o)
        return (
            self.Outputs(co2_erf=co2_erf, ch4_erf=ch4_erf, n2o_erf=n2o_erf),
            internal_state,
        )


GhgForcingBuilder = make_builder(GhgForcing)
