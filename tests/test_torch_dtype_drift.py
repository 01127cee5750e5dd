"""The port's float32 against its own float64 on the year loop
(the counterpart of ``tests/test_dtype_drift.py``).

The same model runs through ``ModelProgram.run_fn`` in both dtypes on the
CPU, and each variable's ``max_t |f32 - f64| / max_t |f64|`` must stay
under the JAX package's bound for the same case: GHG forcing 5e-6, the
ClimateUDEB default 5e-5, and (``slow``, as in the reference) the
time-varying-ECS case 1e-4 and the ten-component emissions-driven graph
5e-4.  The reference's "an f32 program is not promoted" (``:144-160``) is
``tests/test_torch_repairs.py``'s C.4 test.
"""

import numpy as np
import pytest
import torch

from regression.helpers import get_variable_values, load_regression_data
from regression.test_ocean_udeb import step_forcing
from rscm_tpu_torch.core.model.program import ModelProgram
from test_torch_support import build_udeb, params_from_config


def trajectories(model, dtype):
    prog = ModelProgram(model, dtype=dtype, device="cpu")
    params = {nk: {pn: float(v) for pn, v in node.items()}
              for nk, node in prog.gather_params().items()}
    endo, _ = prog.run_fn(prog.gather_endo(1), prog.gather_exo(), params,
                          prog.gather_internals())
    for name, values in endo.items():
        assert values.dtype == dtype, name
    return {k: v[:, 0].to(torch.float64).numpy() for k, v in endo.items()}


def drift(build):
    """Per-variable scale-relative float32 / float64 divergence."""
    t64 = trajectories(build(), torch.float64)
    t32 = trajectories(build(), torch.float32)
    out = {}
    for k in t64:
        a, b = t64[k], t32[k]
        scale = np.nanmax(np.abs(a))
        if not np.isfinite(scale) or scale == 0.0:
            scale = 1.0
        out[k] = float(np.nanmax(np.abs(a - b)) / scale)
    return out


def assert_drift_below(values, bound):
    over = {k: v for k, v in values.items() if not (v < bound)}
    assert not over, (
        f"f32 drift exceeds {bound:g} for: "
        + ", ".join(f"{k}={v:.2e}" for k, v in sorted(over.items()))
    )


def udeb_case(name):
    df, config = load_regression_data("ocean_udeb", name)
    years, _ = get_variable_values(df, "Surface Temperature")
    erf = step_forcing(years, config.get("core_delq2xco2", 3.71))
    return lambda: build_udeb("rscm_tpu_torch", years, erf, from_bounds=True,
                              **params_from_config(config))


def test_ghg_forcing_f32_drift():
    from test_torch_magicc_golden_ghg import build_ghg_forcing_model

    df, config = load_regression_data("ghg_forcing", "01_concentration_driven")
    years, co2 = get_variable_values(df, "Atmospheric Concentrations|CO2")
    _, ch4 = get_variable_values(df, "Atmospheric Concentrations|CH4")
    _, n2o = get_variable_values(df, "Atmospheric Concentrations|N2O")
    values = drift(lambda: build_ghg_forcing_model(years, co2, ch4, n2o, config))
    assert len(values) >= 3
    assert_drift_below(values, 5e-6)


def test_udeb_f32_drift_default():
    values = drift(udeb_case("10_full_default"))
    assert set(values) >= {"Surface Temperature", "Heat Uptake"}
    assert_drift_below(values, 5e-5)


@pytest.mark.slow
def test_udeb_f32_drift_time_varying_ecs():
    assert_drift_below(drift(udeb_case("09_time_varying_ecs")), 1e-4)


@pytest.mark.slow
def test_emissions_driven_f32_drift():
    from regression.test_emissions_driven import _extract_emissions
    from test_torch_magicc_golden_emissions import build_emissions_driven_model

    df, config = load_regression_data("ghg_forcing", "03_emissions_driven")
    years, exp_co2 = get_variable_values(df, "Atmospheric Concentrations|CO2")
    _, exp_ch4 = get_variable_values(df, "Atmospheric Concentrations|CH4")
    _, exp_n2o = get_variable_values(df, "Atmospheric Concentrations|N2O")
    emissions = _extract_emissions(df, years)
    initial_conditions = {
        "Atmospheric Concentration|CO2": float(exp_co2[0]),
        "Atmospheric Concentration|CH4": float(exp_ch4[0]),
        "Atmospheric Concentration|N2O": float(exp_n2o[0]),
        "Surface Temperature": 0.0,
        "Ocean Surface pCO2": float(exp_co2[0]),
        "Cumulative Ocean Uptake": 0.0,
        "Carbon Pool|Plant": 884.86,
        "Carbon Pool|Detritus": 92.77,
        "Carbon Pool|Soil": 1681.53,
        "Carbon Pool|Humus": 836.0,
    }
    values = drift(lambda: build_emissions_driven_model(years, emissions, initial_conditions,
                                                        config))
    assert len(values) >= 20  # the whole coupled graph is exercised
    assert_drift_below(values, 5e-4)
