"""
The full MAGICC-style coupled model as a reusable factory.

Ten components — CH4/N2O chemistry, GHG + ozone + aerosol forcing, the
2x50-layer upwelling-diffusion climate (ClimateUDEB), terrestrial + ocean
carbon, and the CO2 budget closure — wired into one emissions-driven graph
(the same wiring the reference's crates compose, e.g.
``crates/rscm-magicc/src/{chemistry,forcing,carbon,climate}``), with the
optional permafrost and sea-level modules beyond the reference.  Port of
``rscm_tpu/magicc/coupled.py``.
"""

from __future__ import annotations

import numpy as np

from rscm_tpu_torch.core import (
    GridType,
    ModelBuilder,
    TimeAxis,
    Timeseries,
    VariableSchema,
)
from rscm_tpu_torch.core.spatial import ScalarGrid

__all__ = [
    "FORCER_VARIABLES",
    "INITIAL_VALUES",
    "idealised_emissions",
    "build_magicc_schema",
    "build_magicc_model",
]

FORCER_VARIABLES = (
    "Effective Radiative Forcing|CO2",
    "Effective Radiative Forcing|CH4",
    "Effective Radiative Forcing|N2O",
    "Effective Radiative Forcing|O3|Stratospheric",
    "Effective Radiative Forcing|O3|Tropospheric",
    "Effective Radiative Forcing|O3|Temperature Feedback",
    "Effective Radiative Forcing|Aerosol|Direct",
    "Effective Radiative Forcing|Aerosol|Indirect",
)

INITIAL_VALUES = {
    "Atmospheric Concentration|CO2": 284.0,
    "Atmospheric Concentration|CH4": 790.0,
    "Atmospheric Concentration|N2O": 275.0,
    "Surface Temperature": 0.0,
    "Ocean Surface pCO2": 284.0,
    "Cumulative Ocean Uptake": 0.0,
    "Carbon Pool|Plant": 884.86,
    "Carbon Pool|Detritus": 92.77,
    "Carbon Pool|Soil": 1681.53,
    "Carbon Pool|Humus": 836.0,
}

_SCALAR_VARS = (
    ("Atmospheric Concentration|CO2", "ppm"),
    ("Atmospheric Concentration|CH4", "ppb"),
    ("Atmospheric Concentration|N2O", "ppb"),
    ("Heat Uptake", "W/m^2"),
    ("Ocean Heat Content", "J/m^2"),
    ("Sea Surface Temperature", "K"),
    ("Carbon Flux|Terrestrial", "GtC/yr"),
    ("Carbon Flux|Ocean", "GtC/yr"),
    ("Carbon Pool|Plant", "GtC"),
    ("Carbon Pool|Detritus", "GtC"),
    ("Carbon Pool|Soil", "GtC"),
    ("Carbon Pool|Humus", "GtC"),
    ("Ocean Surface pCO2", "ppm"),
    ("Cumulative Ocean Uptake", "GtC"),
    ("Emissions|CO2|Net", "GtC/yr"),
    ("Airborne Fraction|CO2", "1"),
    ("Lifetime|CH4", "yr"),
    ("Lifetime|N2O", "yr"),
)


def idealised_emissions(years: np.ndarray) -> dict:
    """SSP-shaped idealised scenario: fossil CO2 peaks ~3/4 through the
    window; short-lived forcer emissions scale with the fossil ramp."""
    years = np.asarray(years, dtype=np.float64)
    n = len(years)
    t = (years - years[0]) / max(years[-1] - years[0], 1.0)
    fossil = 10.0 * np.exp(-0.5 * ((t - 0.75) / 0.25) ** 2) * t * 2.0  # GtC/yr
    scale = fossil / max(fossil.max(), 1e-9)
    return {
        "Emissions|CO2|Fossil": (fossil, "GtC/yr"),
        "Emissions|CO2|Land Use": (1.0 * (1.0 - t), "GtC/yr"),
        "Emissions|CH4": (100.0 + 250.0 * scale, "Mt CH4/yr"),
        "Emissions|N2O": (5.0 + 5.0 * scale, "Mt N/yr"),
        "Emissions|NOx": (10.0 + 30.0 * scale, "Mt N/yr"),
        "Emissions|CO": (200.0 + 600.0 * scale, "Mt CO/yr"),
        "Emissions|NMVOC": (60.0 + 120.0 * scale, "Mt NMVOC/yr"),
        "Emissions|SOx": (2.0 + 100.0 * scale, "Mt S/yr"),
        "Emissions|BC": (1.0 + 6.0 * scale, "Mt BC/yr"),
        "Emissions|OC": (5.0 + 25.0 * scale, "Mt OC/yr"),
        "EESC": (np.zeros(n), "ppt"),
    }


_PERMAFROST_VARS = (
    ("Emissions|CO2|Permafrost", "GtC/yr"),
    ("Emissions|CH4|Permafrost", "Mt CH4/yr"),
    ("Permafrost|Thawed Area Fraction", "1"),
    ("Permafrost|Total Pool", "GtC"),
)

_SLR_VARS = (
    ("Sea Level Rise", "mm"),
    ("Sea Level Rise|Thermal Expansion", "mm"),
    ("Sea Level Rise|Glaciers", "mm"),
    ("Sea Level Rise|Greenland|SMB", "mm"),
    ("Sea Level Rise|Greenland|SID", "mm"),
    ("Sea Level Rise|Antarctica|SMB", "mm"),
    ("Sea Level Rise|Antarctica|SID", "mm"),
    ("Sea Level Rise|Land Water", "mm"),
    ("Sea Level Rise|Semi-Empirical", "mm"),
)


def build_magicc_schema(
    emissions: dict, include_permafrost: bool = False,
    include_slr: bool = False,
) -> VariableSchema:
    schema = VariableSchema()
    for name, (_, unit) in emissions.items():
        schema.add_variable(name, unit)
    for name, unit in _SCALAR_VARS:
        schema.add_variable(name, unit)
    for name in FORCER_VARIABLES:
        schema.add_variable(name, "W/m^2")
    schema.add_variable("Surface Temperature", "K", GridType.FourBox)
    schema.add_aggregate(
        "Effective Radiative Forcing", "W/m^2", "Sum", list(FORCER_VARIABLES)
    )
    if include_permafrost:
        for name, unit in _PERMAFROST_VARS:
            schema.add_variable(name, unit)
    if include_slr:
        for name, unit in _SLR_VARS:
            schema.add_variable(name, unit)
    return schema


def build_magicc_model(years=None, ecs: float = 3.0, emissions: dict = None,
                       udeb_params: dict = None, ocean_params: dict = None,
                       include_permafrost: bool = False,
                       permafrost_params: dict = None,
                       include_slr: bool = False,
                       slr_params: dict = None,
                       chemistry_pathways: dict = None):
    """Build the ten-component emissions-driven MAGICC-style model.

    The ocean-carbon flux-history window is sized to the run length
    (slots beyond it would stay zero forever); pass ``ocean_params`` to
    override any OceanCarbon parameter, e.g. ``{"history_dtype":
    "bfloat16"}``.  At the default axis (1850-2100) the window is 3024
    months, so the ``"auto"`` engine resolves to exp-sum.

    ``include_permafrost=True`` adds the permafrost carbon feedback
    beyond the reference (module_12): the :class:`Permafrost` component
    plus budget/chemistry variants that fold its CO2 and CH4 release into
    the same closures MAGICC7 uses (``permafrost_params`` sets its
    parameters).

    ``include_slr=True`` adds the sea-level module beyond the reference
    (module_14): :class:`SeaLevelRise` diagnoses all seven contributors
    from the climate state each year (no feedback into the rest of the
    graph, matching MAGICC7's end-of-step ``sealevel_calc``; ``slr_params``
    sets its parameters).

    ``chemistry_pathways`` selects the MAGICC7-mode CH4/N2O schemes: pass
    observed concentration records on the model time axis (``{"ch4": (n,),
    "n2o": (n,), "temperature": (n,) optional}``) and the CH4/N2O
    components are built via :meth:`CH4Chemistry.magicc7` /
    :meth:`N2OChemistry.magicc7` (budget-closure natural emissions,
    feedback reference year, wetland feedback, concentration prescription
    until the switch year).  Without pathways the components use the
    reference-layout scheme.
    """
    from rscm_tpu_torch.magicc import (
        AerosolDirect,
        AerosolIndirect,
        CH4Chemistry,
        CH4ChemistryWithPermafrost,
        ClimateUDEB,
        CO2Budget,
        CO2BudgetWithPermafrost,
        GhgForcing,
        N2OChemistry,
        OceanCarbon,
        OzoneForcing,
        Permafrost,
        SeaLevelRise,
        TerrestrialCarbon,
    )

    if years is None:
        years = np.arange(1850.0, 2101.0)
    years = np.asarray(years, dtype=np.float64)
    if emissions is None:
        emissions = idealised_emissions(years)

    ch4_cls = CH4ChemistryWithPermafrost if include_permafrost else CH4Chemistry
    budget_cls = CO2BudgetWithPermafrost if include_permafrost else CO2Budget

    if chemistry_pathways is not None:
        cp = chemistry_pathways
        ch4_component = ch4_cls.magicc7(
            years,
            cp["ch4"],
            emissions["Emissions|CH4"][0],
            emissions["Emissions|NOx"][0],
            emissions["Emissions|CO"][0],
            emissions["Emissions|NMVOC"][0],
            temperatures=cp.get("temperature"),
        )
        n2o_component = N2OChemistry.magicc7(
            years, cp["n2o"], emissions["Emissions|N2O"][0]
        )
    else:
        ch4_component = ch4_cls(
            ch4_pi=INITIAL_VALUES["Atmospheric Concentration|CH4"]
        )
        n2o_component = N2OChemistry(
            n2o_pi=INITIAL_VALUES["Atmospheric Concentration|N2O"]
        )

    time_axis = TimeAxis.from_values(years)
    builder = (
        ModelBuilder()
        .with_time_axis(time_axis)
        .with_schema(
            build_magicc_schema(emissions, include_permafrost, include_slr)
        )
    )
    if include_permafrost:
        # Inserted FIRST: insertion order drives variable-source
        # classification (reference semantics).  Permafrost's temperature
        # read becomes a lagged index-N read (this year's thaw from the
        # temperature state entering the year), while the budget/chemistry
        # components added below read its emissions same-step at N+1.
        builder = builder.with_component(Permafrost(**(permafrost_params or {})))
    builder = (
        builder
        .with_component(ch4_component)
        .with_component(n2o_component)
        .with_component(
            GhgForcing(
                method="Ipcctar",
                co2_pi=INITIAL_VALUES["Atmospheric Concentration|CO2"],
                ch4_pi=INITIAL_VALUES["Atmospheric Concentration|CH4"],
                n2o_pi=INITIAL_VALUES["Atmospheric Concentration|N2O"],
                adjust_co2=1.0,
                adjust_ch4=1.0,
                adjust_n2o=1.0,
            )
        )
        .with_component(OzoneForcing())
        .with_component(AerosolDirect())
        .with_component(AerosolIndirect())
        .with_component(ClimateUDEB(ecs=ecs, **(udeb_params or {})))
        .with_component(TerrestrialCarbon())
        .with_component(
            OceanCarbon(
                **{
                    "max_history_months": 12 * (len(years) + 1),
                    **(ocean_params or {}),
                }
            )
        )
        .with_component(budget_cls())
    )
    if include_slr:
        # Inserted after ClimateUDEB so the N+1 temperature / OHC of the
        # current step feed it (MAGICC7 calls sealevel_calc at the end of
        # each timestep).  Nothing reads its outputs — pure diagnostics.
        builder = builder.with_component(
            SeaLevelRise(
                **{
                    "max_history_steps": len(years) + 1,
                    **(slr_params or {}),
                }
            )
        )
    for name, (values, unit) in emissions.items():
        builder = builder.with_exogenous_variable(
            name,
            Timeseries(np.asarray(values)[:, None], time_axis, ScalarGrid(), unit),
        )
    initial_values = dict(INITIAL_VALUES)
    if chemistry_pathways is not None:
        # start the prescribed species on their observed records
        initial_values["Atmospheric Concentration|CH4"] = float(
            np.asarray(chemistry_pathways["ch4"])[0]
        )
        initial_values["Atmospheric Concentration|N2O"] = float(
            np.asarray(chemistry_pathways["n2o"])[0]
        )
    return builder.with_initial_values(initial_values).build()
