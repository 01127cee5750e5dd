"""
Aerosol indirect (cloud-albedo) effect: logarithmic in the CCN-weighted
multi-species emission burden.

Mirror of ``crates/rscm-magicc/src/forcing/aerosol_indirect.rs:78-164`` +
``src/parameters/aerosol.rs``.
"""

from __future__ import annotations

from rscm_tpu_torch.components._builder import make_builder
from rscm_tpu_torch.core import xmath as xm
from rscm_tpu_torch.core.component import Component, Input, Output, Parameter

__all__ = ["AerosolIndirect", "AerosolIndirectBuilder"]


class AerosolIndirect(Component):
    """Cloud-albedo indirect aerosol forcing."""

    tags = ("forcing", "aerosol", "indirect", "cloud", "magicc")
    category = "Radiative Forcing"

    sox_emissions = Input("Emissions|SOx", unit="Mt S/yr")
    oc_emissions = Input("Emissions|OC", unit="Mt OC/yr")
    indirect_erf = Output("Effective Radiative Forcing|Aerosol|Indirect", unit="W/m^2")

    cloud_albedo_coefficient = Parameter(default=-1.0, unit="W/m^2")
    reference_burden = Parameter(default=50.0, unit="Tg/yr")
    sox_weight = Parameter(default=1.0)
    oc_weight = Parameter(default=0.3)
    sox_pi = Parameter(default=1.0, unit="Mt S/yr")
    oc_pi = Parameter(default=10.0, unit="Mt OC/yr")

    def calculate_burden(self, sox, oc):
        return self.sox_weight * sox + self.oc_weight * oc

    def preindustrial_burden(self):
        return self.calculate_burden(self.sox_pi, self.oc_pi)

    def calculate_cloud_albedo(self, sox, oc):
        delta_burden = self.calculate_burden(sox, oc) - self.preindustrial_burden()
        safe_delta = xm.maximum(delta_burden, 0.0)
        forcing = self.cloud_albedo_coefficient * xm.log(
            1.0 + safe_delta / self.reference_burden
        )
        return xm.where(delta_burden <= 0.0, 0.0, forcing)

    calculate_forcing = calculate_cloud_albedo

    def solve_ctx(self, ctx, inputs, internal_state):
        return (
            self.Outputs(
                indirect_erf=self.calculate_cloud_albedo(
                    inputs.sox_emissions.get(), inputs.oc_emissions.get()
                )
            ),
            internal_state,
        )


AerosolIndirectBuilder = make_builder(AerosolIndirect)
