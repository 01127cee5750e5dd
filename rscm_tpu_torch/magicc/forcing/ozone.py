"""
Ozone forcing: stratospheric (from EESC), tropospheric (from CH4 and
precursor emissions), and a temperature feedback term.

Mirror of ``crates/rscm-magicc/src/forcing/ozone.rs:90+`` +
``src/parameters/ozone_forcing.rs``.
"""

from __future__ import annotations

from rscm_tpu_torch.components._builder import make_builder
from rscm_tpu_torch.core import xmath as xm
from rscm_tpu_torch.core.component import Component, Input, Output, Parameter

__all__ = ["OzoneForcing", "OzoneForcingBuilder"]


class OzoneForcing(Component):
    """Stratospheric + tropospheric ozone forcing."""

    tags = ("forcing", "ozone", "magicc")
    category = "Radiative Forcing"

    eesc = Input("EESC", unit="ppt")
    ch4_concentration = Input("Atmospheric Concentration|CH4", unit="ppb")
    nox_emissions = Input("Emissions|NOx", unit="Mt N/yr")
    co_emissions = Input("Emissions|CO", unit="Mt CO/yr")
    nmvoc_emissions = Input("Emissions|NMVOC", unit="Mt NMVOC/yr")
    temperature = Input("Surface Temperature", unit="K")
    strat_o3_erf = Output("Effective Radiative Forcing|O3|Stratospheric", unit="W/m^2")
    trop_o3_erf = Output("Effective Radiative Forcing|O3|Tropospheric", unit="W/m^2")
    temp_feedback_erf = Output(
        "Effective Radiative Forcing|O3|Temperature Feedback", unit="W/m^2"
    )

    eesc_reference = Parameter(default=1420.0, unit="ppt", description="EESC at 1979")
    strat_o3_scale = Parameter(default=-0.0043, unit="W/m^2")
    strat_cl_exponent = Parameter(default=1.7)
    trop_radeff = Parameter(default=0.032, unit="W/m^2 per DU")
    trop_oz_ch4 = Parameter(default=5.7, unit="DU per ln ratio")
    trop_oz_nox = Parameter(default=0.168, unit="DU per Mt N/yr")
    trop_oz_co = Parameter(default=0.00396, unit="DU per Mt CO/yr")
    trop_oz_voc = Parameter(default=0.01008, unit="DU per Mt NMVOC/yr")
    ch4_pi = Parameter(default=700.0, unit="ppb")
    nox_pi = Parameter(default=0.0)
    co_pi = Parameter(default=0.0)
    nmvoc_pi = Parameter(default=0.0)
    temp_feedback_scale = Parameter(default=-0.037, unit="W/m^2/K")

    def calculate_strat_forcing(self, eesc):
        delta_eesc = eesc - self.eesc_reference
        safe_delta = xm.maximum(delta_eesc, 0.0)
        forcing = self.strat_o3_scale * (safe_delta / 100.0) ** self.strat_cl_exponent
        return xm.where(delta_eesc <= 0.0, 0.0, forcing)

    def calculate_trop_forcing(self, ch4, nox, co, nmvoc):
        safe_ch4 = xm.maximum(ch4, 1e-30)
        ch4_term = xm.where(
            ch4 > 0.0, self.trop_oz_ch4 * xm.log(safe_ch4 / self.ch4_pi), 0.0
        )
        precursor_term = (
            self.trop_oz_nox * (nox - self.nox_pi)
            + self.trop_oz_co * (co - self.co_pi)
            + self.trop_oz_voc * (nmvoc - self.nmvoc_pi)
        )
        return self.trop_radeff * (ch4_term + precursor_term)

    def calculate_temp_feedback(self, temperature):
        return self.temp_feedback_scale * temperature

    def solve_ctx(self, ctx, inputs, internal_state):
        return (
            self.Outputs(
                strat_o3_erf=self.calculate_strat_forcing(inputs.eesc.get()),
                trop_o3_erf=self.calculate_trop_forcing(
                    inputs.ch4_concentration.get(),
                    inputs.nox_emissions.get(),
                    inputs.co_emissions.get(),
                    inputs.nmvoc_emissions.get(),
                ),
                temp_feedback_erf=self.calculate_temp_feedback(
                    inputs.temperature.get()
                ),
            ),
            internal_state,
        )


OzoneForcingBuilder = make_builder(OzoneForcing)
