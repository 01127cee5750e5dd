"""
Aerosol direct radiative forcing: per-species (SOx, BC, OC, nitrate)
emissions-scaled forcing distributed to a four-box regional pattern.

Mirror of ``crates/rscm-magicc/src/forcing/aerosol_direct.rs:76-223`` +
``src/parameters/aerosol.rs``.
"""

from __future__ import annotations

import numpy as np

from rscm_tpu_torch.components._builder import make_builder
from rscm_tpu_torch.core import xmath as xm
from rscm_tpu_torch.core.component import Component, Input, Output, Parameter
from rscm_tpu_torch.core.state import FourBoxSlice

__all__ = ["AerosolDirect", "AerosolDirectBuilder"]


class AerosolDirect(Component):
    """Direct aerosol forcing with regional distribution."""

    tags = ("forcing", "aerosol", "direct", "magicc")
    category = "Radiative Forcing"

    sox_emissions = Input("Emissions|SOx", unit="Mt S/yr")
    bc_emissions = Input("Emissions|BC", unit="Mt BC/yr")
    oc_emissions = Input("Emissions|OC", unit="Mt OC/yr")
    nox_emissions = Input("Emissions|NOx", unit="Mt N/yr")
    direct_erf = Output(
        "Effective Radiative Forcing|Aerosol|Direct", unit="W/m^2", grid="FourBox"
    )

    sox_coefficient = Parameter(default=-0.0035)
    bc_coefficient = Parameter(default=0.0077)
    oc_coefficient = Parameter(default=-0.002)
    nitrate_coefficient = Parameter(default=-0.001)
    sox_regional = Parameter(default=(0.15, 0.55, 0.10, 0.20), static=True)
    bc_regional = Parameter(default=(0.15, 0.50, 0.15, 0.20), static=True)
    oc_regional = Parameter(default=(0.15, 0.45, 0.15, 0.25), static=True)
    nitrate_regional = Parameter(default=(0.15, 0.50, 0.15, 0.20), static=True)
    sox_pi = Parameter(default=1.0, unit="Mt S/yr")
    bc_pi = Parameter(default=2.5, unit="Mt BC/yr")
    oc_pi = Parameter(default=10.0, unit="Mt OC/yr")
    nox_pi = Parameter(default=10.0, unit="Mt N/yr")

    def calculate_species_forcing(self, sox, bc, oc, nox):
        return {
            "sox": self.sox_coefficient * (sox - self.sox_pi),
            "bc": self.bc_coefficient * (bc - self.bc_pi),
            "oc": self.oc_coefficient * (oc - self.oc_pi),
            "nitrate": self.nitrate_coefficient * (nox - self.nox_pi),
        }

    def calculate_global_forcing(self, sox, bc, oc, nox):
        species = self.calculate_species_forcing(sox, bc, oc, nox)
        return species["sox"] + species["bc"] + species["oc"] + species["nitrate"]

    def distribute_regional(self, species):
        """Blend species regional patterns by |forcing| weights."""
        total = species["sox"] + species["bc"] + species["oc"] + species["nitrate"]
        total_abs = (
            xm.abs(species["sox"])
            + xm.abs(species["bc"])
            + xm.abs(species["oc"])
            + xm.abs(species["nitrate"])
        )
        safe_abs = xm.maximum(total_abs, 1e-300)

        sox_r = np.asarray(self.sox_regional)
        bc_r = np.asarray(self.bc_regional)
        oc_r = np.asarray(self.oc_regional)
        ni_r = np.asarray(self.nitrate_regional)

        regional = []
        for i in range(4):
            weighted_pattern = (
                xm.abs(species["sox"]) * sox_r[i]
                + xm.abs(species["bc"]) * bc_r[i]
                + xm.abs(species["oc"]) * oc_r[i]
                + xm.abs(species["nitrate"]) * ni_r[i]
            ) / safe_abs
            value = total * weighted_pattern
            # degenerate cases mirror aerosol_direct.rs:121-131
            value = xm.where(xm.abs(total_abs) < 1e-15, total / 4.0, value)
            value = xm.where(xm.abs(total) < 1e-15, 0.0, value)
            regional.append(value)
        return FourBoxSlice(*regional)

    def calculate_forcing(self, sox, bc, oc, nox):
        return self.distribute_regional(
            self.calculate_species_forcing(sox, bc, oc, nox)
        )

    def solve_ctx(self, ctx, inputs, internal_state):
        regional = self.calculate_forcing(
            inputs.sox_emissions.get(),
            inputs.bc_emissions.get(),
            inputs.oc_emissions.get(),
            inputs.nox_emissions.get(),
        )
        return self.Outputs(direct_erf=regional), internal_state


AerosolDirectBuilder = make_builder(AerosolDirect)
