"""
Halocarbon chemistry: ~41 species, analytical exponential decay per step,
per-species radiative forcing, EESC computation.

Mirror of ``crates/rscm-magicc/src/chemistry/halocarbon.rs:83-258`` +
``src/parameters/halocarbon.rs`` (23 F-gases + 18 Montreal gases with
MAGICC7 lifetimes/efficiencies/halogen loadings).

Port of ``rscm_tpu/magicc/chemistry/halocarbon.py``.  The per-species
update is vectorised: concentrations stack along a last species axis
(``(members, 41)`` in the year loop, ``(41,)`` on host floats), the
analytical decay and the three forcing sums are single vector operations
over it; only the collection I/O stays name-keyed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rscm_tpu_torch.components._builder import make_builder
from rscm_tpu_torch.core import xmath as xm
from rscm_tpu_torch.core.component import (
    Component,
    Parameter,
    RequirementDefinition,
    RequirementType,
)
from rscm_tpu_torch.core.state import StateValue

__all__ = [
    "HalocarbonSpecies",
    "HALOCARBON_SPECIES",
    "HalocarbonChemistry",
    "HalocarbonChemistryBuilder",
]


@dataclass(frozen=True)
class HalocarbonSpecies:
    name: str
    lifetime: float
    radiative_efficiency: float  # W/m^2 per ppb
    concentration_pi: float  # ppt
    molecular_weight: float
    n_cl: int
    n_br: int
    fractional_release: float
    group: str  # "fgas" | "montreal"


def _s(name, lifetime, radeff, pi, mw, ncl, nbr, frac, group):
    return HalocarbonSpecies(name, lifetime, radeff, pi, mw, ncl, nbr, frac, group)


# 23 F-gases + 18 Montreal gases (halocarbon.rs default tables)
HALOCARBON_SPECIES = (
    _s("CF4", 50000.0, 0.09, 0.0, 88.0, 0, 0, 0.0, "fgas"),
    _s("C2F6", 10000.0, 0.25, 0.0, 138.0, 0, 0, 0.0, "fgas"),
    _s("C3F8", 2600.0, 0.28, 0.0, 188.0, 0, 0, 0.0, "fgas"),
    _s("C4F10", 2600.0, 0.36, 0.0, 238.0, 0, 0, 0.0, "fgas"),
    _s("C5F12", 4100.0, 0.41, 0.0, 288.0, 0, 0, 0.0, "fgas"),
    _s("C6F14", 3100.0, 0.44, 0.0, 338.0, 0, 0, 0.0, "fgas"),
    _s("C7F16", 3000.0, 0.50, 0.0, 388.0, 0, 0, 0.0, "fgas"),
    _s("C8F18", 3000.0, 0.55, 0.0, 438.0, 0, 0, 0.0, "fgas"),
    _s("c-C4F8", 3200.0, 0.32, 0.0, 200.0, 0, 0, 0.0, "fgas"),
    _s("HFC-23", 228.0, 0.18, 0.0, 70.0, 0, 0, 0.0, "fgas"),
    _s("HFC-32", 5.4, 0.11, 0.0, 52.0, 0, 0, 0.0, "fgas"),
    _s("HFC-43-10mee", 17.0, 0.359, 0.0, 252.0, 0, 0, 0.0, "fgas"),
    _s("HFC-125", 31.0, 0.23, 0.0, 120.0, 0, 0, 0.0, "fgas"),
    _s("HFC-134a", 14.0, 0.16, 0.0, 102.0, 0, 0, 0.0, "fgas"),
    _s("HFC-143a", 51.0, 0.16, 0.0, 84.0, 0, 0, 0.0, "fgas"),
    _s("HFC-152a", 1.6, 0.10, 0.0, 66.0, 0, 0, 0.0, "fgas"),
    _s("HFC-227ea", 36.0, 0.26, 0.0, 170.0, 0, 0, 0.0, "fgas"),
    _s("HFC-236fa", 213.0, 0.24, 0.0, 152.0, 0, 0, 0.0, "fgas"),
    _s("HFC-245fa", 7.9, 0.24, 0.0, 134.0, 0, 0, 0.0, "fgas"),
    _s("HFC-365mfc", 8.9, 0.22, 0.0, 148.0, 0, 0, 0.0, "fgas"),
    _s("NF3", 569.0, 0.20, 0.0, 71.0, 0, 0, 0.0, "fgas"),
    _s("SF6", 850.0, 0.57, 0.0, 146.0, 0, 0, 0.0, "fgas"),
    _s("SO2F2", 36.0, 0.20, 0.0, 102.0, 0, 0, 0.0, "fgas"),
    _s("CFC-11", 52.0, 0.295, 0.0, 137.4, 3, 0, 0.47, "montreal"),
    _s("CFC-12", 102.0, 0.364, 0.0, 120.9, 2, 0, 0.23, "montreal"),
    _s("CFC-113", 93.0, 0.30, 0.0, 187.4, 3, 0, 0.29, "montreal"),
    _s("CFC-114", 189.0, 0.31, 0.0, 170.9, 2, 0, 0.12, "montreal"),
    _s("CFC-115", 540.0, 0.20, 0.0, 154.5, 1, 0, 0.04, "montreal"),
    _s("HCFC-22", 11.9, 0.21, 0.0, 86.5, 1, 0, 0.13, "montreal"),
    _s("HCFC-141b", 9.4, 0.16, 0.0, 116.9, 2, 0, 0.34, "montreal"),
    _s("HCFC-142b", 18.0, 0.19, 0.0, 100.5, 1, 0, 0.17, "montreal"),
    _s("CH3CCl3", 5.0, 0.07, 0.0, 133.4, 3, 0, 0.67, "montreal"),
    _s("CCl4", 32.0, 0.174, 0.0, 153.8, 4, 0, 0.56, "montreal"),
    _s("CH3Cl", 0.9, 0.004, 500.0, 50.5, 1, 0, 0.44, "montreal"),
    _s("CH2Cl2", 0.5, 0.028, 0.0, 84.9, 2, 0, 0.0, "montreal"),
    _s("CHCl3", 0.5, 0.07, 0.0, 119.4, 3, 0, 0.0, "montreal"),
    _s("CH3Br", 0.8, 0.004, 5.0, 94.9, 0, 1, 0.60, "montreal"),
    _s("Halon-1211", 16.0, 0.29, 0.0, 165.4, 1, 1, 0.62, "montreal"),
    _s("Halon-1301", 72.0, 0.30, 0.0, 148.9, 0, 1, 0.28, "montreal"),
    _s("Halon-2402", 28.0, 0.31, 0.0, 259.8, 0, 2, 0.65, "montreal"),
    _s("Halon-1202", 2.5, 0.27, 0.0, 209.8, 0, 2, 0.62, "montreal"),
)


class HalocarbonChemistry(Component):
    """Multi-species halocarbon chemistry + forcing + EESC."""

    tags = ("chemistry", "halocarbons", "magicc")
    category = "Atmospheric Chemistry"

    species = Parameter(default=HALOCARBON_SPECIES, static=True)
    br_multiplier = Parameter(default=60.0)
    cfc11_release_normalisation = Parameter(default=0.47)
    eesc_delay = Parameter(default=3.0, unit="yr")
    air_molar_mass = Parameter(default=28.97, unit="g/mol")
    atmospheric_mass_tg = Parameter(default=5.133e9, unit="Tg")
    mixing_box_fraction = Parameter(default=0.949)

    @staticmethod
    def emissions_name(species_name: str) -> str:
        return f"Emissions|{species_name}"

    @staticmethod
    def concentration_name(species_name: str) -> str:
        return f"Atmospheric Concentration|{species_name}"

    def definitions(self):
        defs = []
        for sp in self.species:
            defs.append(
                RequirementDefinition(
                    self.emissions_name(sp.name), "kt/yr", RequirementType.Input
                )
            )
            defs.append(
                RequirementDefinition(
                    self.concentration_name(sp.name), "ppt", RequirementType.State
                )
            )
        defs.append(
            RequirementDefinition("Forcing|Halocarbons", "W/m^2", RequirementType.Output)
        )
        defs.append(
            RequirementDefinition("Forcing|F-gases", "W/m^2", RequirementType.Output)
        )
        defs.append(
            RequirementDefinition(
                "Forcing|Montreal Gases", "W/m^2", RequirementType.Output
            )
        )
        defs.append(RequirementDefinition("EESC", "ppt", RequirementType.Output))
        return defs

    # -- static species tables -------------------------------------------------

    def _tables(self):
        sp = self.species
        return {
            "lifetime": np.array([s.lifetime for s in sp]),
            "radeff": np.array([s.radiative_efficiency for s in sp]),
            "conc_pi": np.array([s.concentration_pi for s in sp]),
            "mw": np.array([s.molecular_weight for s in sp]),
            "halogen": np.array(
                [s.n_cl + 0.0 for s in sp]
            ),  # br added with multiplier below
            "n_br": np.array([s.n_br + 0.0 for s in sp]),
            "frac_release": np.array([s.fractional_release for s in sp]),
            "is_fgas": np.array([1.0 if s.group == "fgas" else 0.0 for s in sp]),
        }

    def emission_to_concentration_factor(self, molecular_weight):
        """kt/yr -> ppt/yr (halocarbon.rs ``emission_to_concentration_factor``)."""
        atm_mass_g = _species_axis(self.atmospheric_mass_tg) * 1e12
        return (
            (_species_axis(self.air_molar_mass) / molecular_weight)
            * (1e9 / atm_mass_g)
            * 1e12
            / _species_axis(self.mixing_box_fraction)
        )

    # -- physics ----------------------------------------------------------------

    def decay_species_vector(self, concentrations, emissions, dt, tables):
        decay = xm.exp(-dt / tables["lifetime"])
        conv = self.emission_to_concentration_factor(tables["mw"])
        emissions_ppt = emissions * conv
        return concentrations * decay + emissions_ppt * tables["lifetime"] * (1.0 - decay)

    def forcing_vector(self, concentrations, tables):
        return (concentrations - tables["conc_pi"]) * tables["radeff"] / 1000.0

    def eesc_vector(self, concentrations, tables):
        halogen_loading = tables["halogen"] + _species_axis(self.br_multiplier) * tables["n_br"]
        normalised_release = tables["frac_release"] / _species_axis(
            self.cfc11_release_normalisation
        )
        active = tables["frac_release"] > 0.0
        contrib = concentrations * halogen_loading * normalised_release
        return xm.where(active, contrib, 0.0)

    def solve_ctx(self, ctx, input_state, internal_state):
        dt = ctx.t_next - ctx.t_current
        tables = self._tables()

        conc = _stack_species(
            [
                input_state.get_window(self.concentration_name(sp.name)).get()
                for sp in self.species
            ]
        )
        emis = _stack_species(
            [
                input_state.get_window(self.emissions_name(sp.name)).get()
                for sp in self.species
            ]
        )
        if isinstance(conc, torch.Tensor):
            tables = {
                k: torch.as_tensor(v, dtype=conc.dtype, device=conc.device)
                for k, v in tables.items()
            }

        new_conc = self.decay_species_vector(conc, emis, dt, tables)
        forcings = self.forcing_vector(new_conc, tables)
        total_forcing = forcings.sum(-1)
        fgas_forcing = (forcings * tables["is_fgas"]).sum(-1)
        montreal_forcing = total_forcing - fgas_forcing
        eesc = self.eesc_vector(new_conc, tables).sum(-1)

        outputs = {
            self.concentration_name(sp.name): StateValue.scalar(new_conc[..., i])
            for i, sp in enumerate(self.species)
        }
        outputs["Forcing|Halocarbons"] = StateValue.scalar(total_forcing)
        outputs["Forcing|F-gases"] = StateValue.scalar(fgas_forcing)
        outputs["Forcing|Montreal Gases"] = StateValue.scalar(montreal_forcing)
        outputs["EESC"] = StateValue.scalar(eesc)
        return outputs, internal_state

    # convenience mirrors of the reference's dict-based API (used in tests)
    def decay_species(self, species: HalocarbonSpecies, concentration, emissions, dt):
        decay = float(np.exp(-dt / species.lifetime))
        conv = self.emission_to_concentration_factor(species.molecular_weight)
        return concentration * decay + emissions * conv * species.lifetime * (1.0 - decay)

    def species_forcing(self, species: HalocarbonSpecies, concentration):
        return (concentration - species.concentration_pi) * species.radiative_efficiency / 1000.0

    def get_species(self, name: str):
        for sp in self.species:
            if sp.name == name:
                return sp
        return None


def _species_axis(param):
    """A per-member ``(members,)`` parameter with a trailing axis, so it
    broadcasts against the species axis; shared values as they are."""
    if isinstance(param, torch.Tensor) and param.dim() >= 1:
        return param[..., None]
    return param


def _stack_species(values):
    """Per-species values stacked along a last species axis: host floats
    into a ``(species,)`` array, tensors (``(members,)`` or 0-d) broadcast
    to one shape first."""
    if any(isinstance(v, torch.Tensor) for v in values):
        ref = next(v for v in values if isinstance(v, torch.Tensor))
        tensors = [torch.as_tensor(v, dtype=ref.dtype, device=ref.device) for v in values]
        shape = torch.broadcast_shapes(*(t.shape for t in tensors))
        return torch.stack([t.expand(shape) for t in tensors], dim=-1)
    return xm.stack(values)


HalocarbonChemistryBuilder = make_builder(HalocarbonChemistry)
