"""The golden emissions-driven suite through the port.

Every test of ``tests/regression/test_emissions_driven.py`` that is neither
``slow`` nor ``xfail``, with the ten-component graph built as that file
builds it (``OceanCarbon()``'s 6000-month window: the exp-sum engine) from
``rscm_tpu_torch``'s classes, run with ``Model.run(device="cpu")`` where
the reference runs ``model.run(compiled=False)``, at that file's bounds.
"""

import numpy as np
import pytest

from regression.helpers import get_variable_values, load_regression_data
from regression.test_emissions_driven import _extract_emissions
from rscm_tpu_torch.core import ModelBuilder, TimeAxis, Timeseries
from rscm_tpu_torch.core.spatial import ScalarGrid
from rscm_tpu_torch.magicc import (
    AerosolDirect,
    AerosolIndirect,
    CH4Chemistry,
    ClimateUDEB,
    CO2Budget,
    GhgForcing,
    N2OChemistry,
    OceanCarbon,
    OzoneForcing,
    TerrestrialCarbon,
)
from rscm_tpu_torch.magicc.coupled import build_magicc_schema


def build_emissions_driven_model(years, emissions, initial_conditions, config,
                                 magicc7_chemistry=None):
    """The reference suite's ten-component graph, from the port's classes."""
    axis = TimeAxis.from_bounds(np.concatenate([years, [years[-1] + 1.0]]).astype(np.float64))
    ghg = GhgForcing(
        method="Ipcctar",
        delq2xco2=config.get("core_delq2xco2", 3.71),
        co2_pi=initial_conditions.get("Atmospheric Concentration|CO2", 278.0),
        ch4_pi=initial_conditions.get("Atmospheric Concentration|CH4", 700.0),
        n2o_pi=initial_conditions.get("Atmospheric Concentration|N2O", 270.0),
        adjust_co2=1.0, adjust_ch4=1.0, adjust_n2o=1.0,
    )
    climate = ClimateUDEB(ecs=config.get("core_climatesensitivity", 3.0),
                          rf_2xco2=config.get("core_delq2xco2", 3.71))
    if magicc7_chemistry is not None:
        g = magicc7_chemistry
        ch4 = CH4Chemistry.magicc7(
            years, g["ch4"], emissions["Emissions|CH4"][0], emissions["Emissions|NOx"][0],
            emissions["Emissions|CO"][0], emissions["Emissions|NMVOC"][0],
            temperatures=g["temp"],
        )
        n2o = N2OChemistry.magicc7(years, g["n2o"], emissions["Emissions|N2O"][0])
    else:
        ch4 = CH4Chemistry(ch4_pi=initial_conditions.get("Atmospheric Concentration|CH4", 722.0))
        n2o = N2OChemistry(n2o_pi=initial_conditions.get("Atmospheric Concentration|N2O", 270.0))
    builder = (
        ModelBuilder()
        .with_time_axis(axis)
        .with_schema(build_magicc_schema(emissions))
        .with_component(ch4)
        .with_component(n2o)
        .with_component(ghg)
        .with_component(OzoneForcing())
        .with_component(AerosolDirect())
        .with_component(AerosolIndirect())
        .with_component(climate)
        .with_component(TerrestrialCarbon())
        .with_component(OceanCarbon())
        .with_component(CO2Budget())
    )
    for name, (values, unit) in emissions.items():
        builder = builder.with_exogenous_variable(
            name, Timeseries(np.asarray(values, float)[:, None], axis, ScalarGrid(), unit))
    return builder.with_initial_values(initial_conditions).build()


@pytest.fixture(scope="module")
def emissions_setup():
    df, config = load_regression_data("ghg_forcing", "03_emissions_driven")
    years, co2 = get_variable_values(df, "Atmospheric Concentrations|CO2")
    _, ch4 = get_variable_values(df, "Atmospheric Concentrations|CH4")
    _, n2o = get_variable_values(df, "Atmospheric Concentrations|N2O")
    _, temp = get_variable_values(df, "Surface Temperature")
    initial_conditions = {
        "Atmospheric Concentration|CO2": float(co2[0]),
        "Atmospheric Concentration|CH4": float(ch4[0]),
        "Atmospheric Concentration|N2O": float(n2o[0]),
        "Surface Temperature": 0.0,
        "Ocean Surface pCO2": float(co2[0]),
        "Cumulative Ocean Uptake": 0.0,
        "Carbon Pool|Plant": 884.86,
        "Carbon Pool|Detritus": 92.77,
        "Carbon Pool|Soil": 1681.53,
        "Carbon Pool|Humus": 836.0,
    }
    expected = {"co2": co2, "ch4": ch4, "n2o": n2o, "temp": temp}
    return years, _extract_emissions(df, years), initial_conditions, config, expected


def run(model):
    model.run(device="cpu")
    results = model.timeseries()

    def get(name):
        return np.asarray(results.get_timeseries_by_name(name).values()).ravel()

    return get


def rel(actual, expected):
    return np.abs(actual[1:] - expected[:-1]) / np.abs(expected[:-1])


@pytest.fixture(scope="module")
def magicc7_run(emissions_setup):
    years, emissions, ic, config, expected = emissions_setup
    model = build_emissions_driven_model(years, emissions, ic, config,
                                         magicc7_chemistry=expected)
    ocean = next(c for c in model.graph.nodes if type(c).__name__ == "OceanCarbon")
    assert ocean.resolved_engine() == "expsum"
    return run(model)


@pytest.fixture(scope="module")
def reference_scheme_run(emissions_setup):
    years, emissions, ic, config, _ = emissions_setup
    return run(build_emissions_driven_model(years, emissions, ic, config))


def test_emissions_driven_pathway_runs(emissions_setup, magicc7_run):
    expected = emissions_setup[4]
    co2 = magicc7_run("Atmospheric Concentration|CO2")
    ch4 = magicc7_run("Atmospheric Concentration|CH4")
    n2o = magicc7_run("Atmospheric Concentration|N2O")
    sst = magicc7_run("Sea Surface Temperature")
    assert np.all(np.isfinite(co2[1:])) and np.all(np.isfinite(ch4[1:]))
    assert np.all(np.isfinite(sst[1:]))
    assert co2[-1] > co2[1] + 50.0
    assert sst[-1] > 0.5
    rel_co2_end = abs(co2[-1] - expected["co2"][-2]) / expected["co2"][-2]
    assert rel_co2_end < 0.05, f"CO2 end-of-century off by {rel_co2_end:.1%}"
    assert rel(co2, expected["co2"]).max() < 0.04
    assert rel(ch4, expected["ch4"]).max() < 0.05
    assert rel(n2o, expected["n2o"]).max() < 0.02


def test_emissions_driven_reference_scheme_parity(emissions_setup, reference_scheme_run):
    expected = emissions_setup[4]
    get = reference_scheme_run
    assert rel(get("Atmospheric Concentration|CO2"), expected["co2"]).max() < 0.04
    assert rel(get("Atmospheric Concentration|CH4"), expected["ch4"]).max() < 0.20
    assert rel(get("Atmospheric Concentration|N2O"), expected["n2o"]).max() < 0.10


def test_emissions_driven_magicc7_chemistry_parity(emissions_setup, magicc7_run):
    expected = emissions_setup[4]
    assert rel(magicc7_run("Atmospheric Concentration|CH4"), expected["ch4"]).max() < 0.05
    assert rel(magicc7_run("Atmospheric Concentration|N2O"), expected["n2o"]).max() < 0.02
    assert np.all(np.isfinite(magicc7_run("Sea Surface Temperature")[1:]))


def test_emissions_driven_carbon_conservation(reference_scheme_run):
    """Atmosphere growth == net emissions (budget closure identity)."""
    co2 = reference_scheme_run("Atmospheric Concentration|CO2")
    net = reference_scheme_run("Emissions|CO2|Net")
    np.testing.assert_allclose(np.diff(co2[1:]) * 2.123, net[2:], rtol=1e-9, atol=1e-9)


def test_ch4_inverse_emissions_consistency(emissions_setup):
    """The reference test's inversion of the magicc7-mode CH4 update for the
    natural emissions that reproduce the golden record, through the port's
    ``CH4Chemistry`` on host floats, at the reference's bounds."""
    years, emissions, _, _, expected = emissions_setup
    ch4 = np.asarray(expected["ch4"], dtype=np.float64)
    temp = np.asarray(expected["temp"], dtype=np.float64)
    anthro, nox, co, nmvoc = (np.asarray(emissions[k][0], dtype=np.float64) for k in (
        "Emissions|CH4", "Emissions|NOx", "Emissions|CO", "Emissions|NMVOC"))
    comp = CH4Chemistry.magicc7(years, ch4, anthro, nox, co, nmvoc, temperatures=temp)

    def step(t, e):
        c, _ = comp._solve_concentration_magicc7(ch4[t], e, temp[t], nox[t], co[t], nmvoc[t])
        return float(c)

    implied = np.empty(len(years) - 1)
    for t in range(len(years) - 1):
        target = ch4[t + 1]
        e0, e1 = anthro[t], anthro[t] + 50.0
        f0, f1 = step(t, e0) - target, step(t, e1) - target
        for _ in range(30):
            if abs(f1) < 1e-10 or f1 == f0:
                break
            e2 = e1 - f1 * (e1 - e0) / (f1 - f0)
            e0, f0 = e1, f1
            e1, f1 = e2, step(t, e2) - target
        assert abs(f1) < 1e-6, f"inversion failed to close at year {years[t]}"
        wetland = comp.wetland_slope * max(temp[t] - comp.temp_reference, 0.0)
        implied[t] = (e1 - anthro[t]) + comp.natural_emissions + wetland

    assert implied.min() > 140.0 and implied.max() < 260.0
    assert abs(implied[:10].mean() - comp.natural_emissions) / comp.natural_emissions < 0.03
    pre2015 = implied[: int(np.searchsorted(years, 2015.0))]
    decades = np.array([pre2015[i : i + 10].mean() for i in range(0, len(pre2015) - 10, 10)])
    assert (np.abs(decades - pre2015.mean()) / pre2015.mean()).max() < 0.10


def test_emissions_driven_magicc7_late_start(emissions_setup):
    years, emissions, ic, config, expected = emissions_setup
    start = int(np.searchsorted(years, 1950.0))
    y2 = years[start:]
    emissions2 = {k: (v[start:], u) for k, (v, u) in emissions.items()}
    ic2 = dict(ic)
    ic2.update({
        "Atmospheric Concentration|CO2": float(expected["co2"][start]),
        "Atmospheric Concentration|CH4": float(expected["ch4"][start]),
        "Atmospheric Concentration|N2O": float(expected["n2o"][start]),
        "Surface Temperature": float(expected["temp"][start]),
        "Ocean Surface pCO2": float(expected["co2"][start]),
    })
    expected2 = {k: v[start:] for k, v in expected.items()}
    get = run(build_emissions_driven_model(y2, emissions2, ic2, config,
                                           magicc7_chemistry=expected2))
    assert rel(get("Atmospheric Concentration|CH4"), expected2["ch4"]).max() < 0.05
    assert rel(get("Atmospheric Concentration|N2O"), expected2["n2o"]).max() < 0.02
    assert rel(get("Atmospheric Concentration|CO2"), expected2["co2"]).max() < 0.12
