"""The golden GHG-forcing suite through the port.

The cases of ``tests/regression/test_ghg_forcing.py`` that pass there
(01, 02, 04 at all five ECS, 05; 03 is ``xfail`` there and left out), built
as that file builds them but with ``rscm_tpu_torch``'s classes, run with
``Model.run(device="cpu")`` and held to that file's bounds: forcing at
rtol 1e-5 / atol 1e-6, temperature phased at shock 5e-2, converge and
final 3e-2.  No rows go to the parity report.
"""

import numpy as np
import pytest

from regression.helpers import fourbox_global_mean, get_variable_values, load_regression_data
from rscm_tpu_torch.core import GridType, ModelBuilder, TimeAxis, Timeseries, VariableSchema
from rscm_tpu_torch.core.spatial import ScalarGrid
from rscm_tpu_torch.magicc import ClimateUDEB, GhgForcing
from test_torch_support import assert_phased

SUITE = "ghg_forcing"
DEFAULT_RTOL = 1e-5
DEFAULT_ATOL = 1e-6


def _time_axis(years):
    return TimeAxis.from_bounds(np.concatenate([years, [years[-1] + 1.0]]).astype(np.float64))


def build_ghg_forcing_model(years, co2_conc, ch4_conc, n2o_conc, config):
    rf_method = config.get("core_co2ch4n2o_rfmethod", "IPCCTAR")
    method, adj = {"IPCCTAR": ("Ipcctar", (1.0, 1.0, 1.0)),
                   "OLBL": ("Olbl", (1.05, 0.86, 1.0))}[rf_method]
    component = GhgForcing(
        method=method,
        delq2xco2=config.get("core_delq2xco2", 3.71),
        co2_pi=float(co2_conc[0]),
        ch4_pi=float(ch4_conc[0]),
        n2o_pi=float(n2o_conc[0]),
        adjust_co2=config.get("core_rfrapidadjust_co2", adj[0]),
        adjust_ch4=config.get("core_rfrapidadjust_ch4", adj[1]),
        adjust_n2o=config.get("core_rfrapidadjust_n2o", adj[2]),
    )
    axis = _time_axis(years)
    builder = ModelBuilder().with_time_axis(axis).with_component(component)
    for name, values, unit in [
        ("Atmospheric Concentration|CO2", co2_conc, "ppm"),
        ("Atmospheric Concentration|CH4", ch4_conc, "ppb"),
        ("Atmospheric Concentration|N2O", n2o_conc, "ppb"),
    ]:
        builder = builder.with_exogenous_variable(
            name, Timeseries(values.astype(np.float64)[:, None], axis, ScalarGrid(), unit))
    return builder.build()


def build_erf_to_temperature_model(years, erf, config):
    axis = _time_axis(years)
    schema = VariableSchema()
    schema.add_variable("Effective Radiative Forcing", "W/m^2")
    schema.add_variable("Surface Temperature", "K", GridType.FourBox)
    schema.add_variable("Heat Uptake", "W/m^2")
    schema.add_variable("Ocean Heat Content", "J/m^2")
    schema.add_variable("Sea Surface Temperature", "K")
    return (
        ModelBuilder()
        .with_time_axis(axis)
        .with_schema(schema)
        .with_component(ClimateUDEB(ecs=config.get("core_climatesensitivity", 3.0),
                                    rf_2xco2=config.get("core_delq2xco2", 3.71)))
        .with_exogenous_variable(
            "Effective Radiative Forcing",
            Timeseries(erf.astype(np.float64)[:, None], axis, ScalarGrid(), "W/m^2"))
        .with_initial_values({"Surface Temperature": 0.0})
        .build()
    )


@pytest.mark.parametrize("name, method", [("01_concentration_driven", "IPCCTAR"),
                                          ("02_ghg_forcing_olbl", "OLBL")])
def test_forcing_scenario_through_port(name, method):
    df, config = load_regression_data(SUITE, name)
    assert config.get("core_co2ch4n2o_rfmethod") == method
    years, co2 = get_variable_values(df, "Atmospheric Concentrations|CO2")
    _, ch4 = get_variable_values(df, "Atmospheric Concentrations|CH4")
    _, n2o = get_variable_values(df, "Atmospheric Concentrations|N2O")
    model = build_ghg_forcing_model(years, co2, ch4, n2o, config)
    model.run(device="cpu")
    results = model.timeseries()
    for gas in ("CO2", "CH4", "N2O"):
        actual = results.get_timeseries_by_name(f"Effective Radiative Forcing|{gas}").values()[1:]
        _, expected = get_variable_values(df, f"Effective Radiative Forcing|{gas}")
        np.testing.assert_allclose(np.asarray(actual).reshape(-1), expected[:-1],
                                   rtol=DEFAULT_RTOL, atol=DEFAULT_ATOL, err_msg=f"{name} {gas}")


def _temperature_case(name, erf_variable):
    df, config = load_regression_data(SUITE, name)
    years, erf = get_variable_values(df, erf_variable)
    _, expected = get_variable_values(df, "Surface Temperature")
    model = build_erf_to_temperature_model(years, erf, config)
    model.run(device="cpu")
    temp = model.timeseries().get_fourbox_timeseries_by_name("Surface Temperature")
    assert_phased(fourbox_global_mean(temp.values()), expected, shock_rtol=5e-2,
                  converge_rtol=3e-2, final_rtol=3e-2, atol=DEFAULT_ATOL, name=name)
    return config


@pytest.mark.parametrize("ecs", [1.5, 2.0, 3.0, 4.0, 4.5])
def test_04_ecs_sweep_through_port(ecs):
    config = _temperature_case(f"04_ecs_sweep_{ecs}", "Effective Radiative Forcing|CO2")
    assert config.get("core_climatesensitivity") == ecs


def test_05_co2_only_forcing_through_port():
    df, config = load_regression_data(SUITE, "05_co2_only_forcing")
    assert config.get("rf_total_runmodus") == "CO2"
    _, total = get_variable_values(df, "Effective Radiative Forcing")
    _, co2 = get_variable_values(df, "Effective Radiative Forcing|CO2")
    np.testing.assert_allclose(total, co2, rtol=1e-6)
    _temperature_case("05_co2_only_forcing", "Effective Radiative Forcing")
