"""MAGICC parameter status registry + coverage reporting.

Mirror of ``python/rscm/config/models/magicc/parameters.py:17-434`` with one
difference: the GHG forcing method / rapid-adjustment parameters are
SUPPORTED here (the rebuild's GhgForcing implements IPCCTAR and OLBL with
adjustments), where the reference still tracked them NOT_IMPLEMENTED.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, auto
from typing import Dict, Optional

__all__ = [
    "ParameterStatus",
    "ParameterInfo",
    "MAGICC_PARAMETERS",
    "get_coverage_report",
    "get_coverage_stats",
]


class ParameterStatus(Enum):
    SUPPORTED = auto()  # Mapped to a config path
    NOT_IMPLEMENTED = auto()  # Feature not yet implemented
    NOT_NEEDED = auto()  # Output/file control handled differently
    DEPRECATED = auto()  # Superseded in MAGICC7


@dataclass
class ParameterInfo:
    name: str
    status: ParameterStatus
    rscm_path: Optional[str] = None
    unit: Optional[str] = None
    description: Optional[str] = None
    category: Optional[str] = None

    def __post_init__(self):
        if self.status == ParameterStatus.SUPPORTED and self.rscm_path is None:
            raise ValueError(f"SUPPORTED parameter '{self.name}' must have rscm_path")


def _p(name, status, rscm_path=None, unit=None, description=None, category=None):
    return ParameterInfo(name, status, rscm_path, unit, description, category)


_S = ParameterStatus.SUPPORTED
_NI = ParameterStatus.NOT_IMPLEMENTED
_NN = ParameterStatus.NOT_NEEDED

MAGICC_PARAMETERS: Dict[str, ParameterInfo] = {
    p.name: p
    for p in [
        # time
        _p("startyear", _S, "time.start", "year", "Simulation start year", "time"),
        _p("endyear", _S, "time.end", "year", "Simulation end year", "time"),
        # climate sensitivity & forcing
        _p(
            "core_climatesensitivity", _S,
            "components.climate.parameters.climate_sensitivity", "K",
            "Equilibrium climate sensitivity for 2xCO2", "climate",
        ),
        _p(
            "core_delq2xco2", _S,
            "components.climate.parameters.forcing_2xco2", "W/m^2",
            "Radiative forcing from doubling CO2", "climate",
        ),
        # GHG forcing method (implemented by GhgForcing in this rebuild)
        _p(
            "core_co2ch4n2o_rfmethod", _S,
            "components.ghg_forcing.parameters.method", None,
            "Method for CO2/CH4/N2O forcing (IPCCTAR/OLBL)", "forcing",
        ),
        _p(
            "core_rfrapidadjust_co2", _S,
            "components.ghg_forcing.parameters.adjust_co2", None,
            "Rapid adjustment factor for CO2 forcing", "forcing",
        ),
        _p(
            "core_rfrapidadjust_ch4", _S,
            "components.ghg_forcing.parameters.adjust_ch4", None,
            "Rapid adjustment factor for CH4 forcing", "forcing",
        ),
        _p(
            "core_rfrapidadjust_n2o", _S,
            "components.ghg_forcing.parameters.adjust_n2o", None,
            "Rapid adjustment factor for N2O forcing", "forcing",
        ),
        # forcing scaling
        _p(
            "rf_solar_scale", _S,
            "components.forcing.parameters.solar_scale", None,
            "Scaling factor for solar forcing", "forcing",
        ),
        _p(
            "rf_volcanic_scale", _S,
            "components.forcing.parameters.volcanic_scale", None,
            "Scaling factor for volcanic forcing", "forcing",
        ),
        _p("rf_total_runmodus", _NI, None, None,
           "Run mode restricting which forcings contribute", "forcing"),
        _p(
            "rf_efficacy_apply", _S,
            "components.climate.parameters.efficacy_apply", None,
            "Forcing efficacy application mode", "forcing",
        ),
        _p(
            "rf_efficacy_co2", _S,
            "components.climate.parameters.prescribed_efficacy_co2", None,
            "Prescribed CO2 forcing efficacy", "forcing",
        ),
        # carbon cycle switches
        _p("co2_switchfromconc2emis_year", _NI, None, "year",
           "Year to switch CO2 from concentration- to emissions-driven",
           "carbon_cycle"),
        _p("ch4_switchfromconc2emis_year", _NI, None, "year",
           "Year to switch CH4 from concentration- to emissions-driven",
           "carbon_cycle"),
        _p("n2o_switchfromconc2emis_year", _NI, None, "year",
           "Year to switch N2O from concentration- to emissions-driven",
           "carbon_cycle"),
        # file inputs (handled via exogenous timeseries instead)
        _p("file_co2_conc", _NN, None, None, None, "file"),
        _p("file_ch4_conc", _NN, None, None, None, "file"),
        _p("file_n2o_conc", _NN, None, None, None, "file"),
        _p("file_emisscen", _NN, None, None, None, "file"),
        # output controls (all variables are always available)
        _p("out_forcing", _NN, None, None, None, "output"),
        _p("out_concentrations", _NN, None, None, None, "output"),
        _p("out_emissions", _NN, None, None, None, "output"),
        _p("out_temperature", _NN, None, None, None, "output"),
        _p("out_carboncycle", _NN, None, None, None, "output"),
        _p("out_ascii_binary", _NN, None, None, None, "output"),
        # ocean / climate physics
        _p(
            "core_initial_upwelling_rate", _S,
            "components.climate.parameters.w_initial", "m/yr",
            "Initial ocean upwelling rate", "climate",
        ),
        _p(
            "core_upwelling_variable_part", _S,
            "components.climate.parameters.w_variable_fraction", "1",
            "Temperature-variable fraction of upwelling", "climate",
        ),
        _p(
            "core_ocn_depthdependent", _S,
            "components.climate.parameters.depth_dependent_area", "1",
            "Depth-dependent ocean area (hypsometric profile)", "climate",
        ),
        _p(
            "core_verticaldiff_top_dkdt", _S,
            "components.climate.parameters.kappa_dkdt", "cm^2/s/K",
            "Temperature dependence of vertical diffusivity", "climate",
        ),
        _p(
            "core_landheatcapacity_apply", _S,
            "components.climate.parameters.land_heat_capacity_enabled", None,
            "Enable land (ground) heat capacity damping", "climate",
        ),
        _p(
            "core_landhc_effthickness", _S,
            "components.climate.parameters.land_hc_eff_thickness", "m",
            "Effective thickness of the ground heat reservoir", "climate",
        ),
        _p(
            "core_heatxchange_landground", _S,
            "components.climate.parameters.k_lg", "W/m^2/K",
            "Land-ground heat exchange coefficient", "climate",
        ),
        _p(
            "core_heatxchange_northsouth", _S,
            "components.climate.parameters.k_ns", "W/m^2/K",
            "Inter-hemispheric heat exchange coefficient", "climate",
        ),
        _p(
            "core_feedback_cumtsensitivity", _S,
            "components.climate.parameters.feedback_cumt_sensitivity", "1",
            "Cumulative-temperature ECS feedback sensitivity", "climate",
        ),
        _p(
            "core_feedback_qsensitivity", _S,
            "components.climate.parameters.feedback_q_sensitivity", "1",
            "Forcing-level ECS feedback sensitivity", "climate",
        ),
        _p("core_amv_apply", _NI, None, None,
           "Atlantic multidecadal variability mode", "climate"),
        _p("core_elnino_apply", _NI, None, None, "El Nino variability mode",
           "climate"),
        _p("ch4_incl_ch4ox", _NI, None, None,
           "Include CH4 oxidation source of CO2", "carbon_cycle"),
    ]
}


def _registry_by_status() -> Dict[ParameterStatus, list]:
    groups: Dict[ParameterStatus, list] = {s: [] for s in ParameterStatus}
    for info in MAGICC_PARAMETERS.values():
        groups[info.status].append(info)
    return groups


def get_coverage_stats() -> dict:
    """Per-status counts of the registry, plus ``total``."""
    groups = _registry_by_status()
    stats = {status.name: len(members) for status, members in groups.items()}
    stats["total"] = len(MAGICC_PARAMETERS)
    return stats


def _supported_table(params) -> list:
    rows = ["| Parameter | Config Path | Unit |", "|-----------|-------------|------|"]
    rows += [
        f"| `{p.name}` | `{p.rscm_path}` | {p.unit or '-'} |"
        for p in sorted(params, key=lambda p: p.name)
    ]
    return rows


def _categorised_bullets(params) -> list:
    """Non-supported parameters listed as bullets under category headings."""
    categories: Dict[str, list] = {}
    for p in params:
        categories.setdefault(p.category or "other", []).append(p)
    rows: list = []
    for category in sorted(categories):
        rows += [f"### {category}", ""]
        for p in sorted(categories[category], key=lambda p: p.name):
            note = f" — {p.description}" if p.description else ""
            rows.append(f"- `{p.name}`{note}")
        rows.append("")
    return rows


def get_coverage_report() -> str:
    """Markdown report of MAGICC parameter support by status."""
    groups = _registry_by_status()

    summary = [
        "# MAGICC Parameter Support Report",
        "",
        "Support status of MAGICC .CFG parameters in rscm_tpu.",
        "",
        "## Summary",
        "",
        "| Status | Count |",
        "|--------|-------|",
        *(f"| {s.name} | {len(groups[s])} |" for s in ParameterStatus),
        f"| **Total** | **{len(MAGICC_PARAMETERS)}** |",
        "",
    ]

    sections: list = []
    for status in ParameterStatus:
        members = groups[status]
        if not members:
            continue
        body = (
            _supported_table(members)
            if status == ParameterStatus.SUPPORTED
            else _categorised_bullets(members)
        )
        sections += [f"## {status.name} ({len(members)} parameters)", "", *body, ""]

    return "\n".join(summary + sections)
