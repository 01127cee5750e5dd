"""Ensembles and the golden MAGICC7 case through the port.

- An ensemble swept over ECS and kappa runs through both packages'
  ``EnsembleRunner``s, the port's parameters carried across from the JAX
  package's with ``rscm_tpu_torch.convert``; bar 1e-8 / atol 1e-9, as
  ``tests/test_udeb_pallas.py`` holds its batched kernel route.
- The golden 10_full_default regression case (and the two other 1pctCO2 /
  short cases of ``tests/regression/test_ocean_udeb.py``) run through the
  port as that file builds them, at its tolerances.
"""

import numpy as np
import pytest
import torch

from regression.helpers import fourbox_global_mean, get_variable_values, load_regression_data
from rscm_tpu.parallel import EnsembleRunner as JaxEnsembleRunner
from rscm_tpu_torch.convert import params_from_jax
from rscm_tpu_torch.parallel import EnsembleRunner
from test_torch_support import build_udeb, step_erf

YEARS = np.arange(1850.0, 1900.0)
OUT = ["Surface Temperature", "Sea Surface Temperature", "Heat Uptake"]


@pytest.fixture(scope="module")
def sweep():
    rng = np.random.default_rng(2)
    return {
        "ClimateUDEB.ecs": rng.uniform(2.0, 5.0, 5),
        "ClimateUDEB.kappa": rng.uniform(0.4, 1.5, 5),
    }


@pytest.fixture(scope="module")
def jax_ensemble(sweep):
    runner = JaxEnsembleRunner(build_udeb("rscm_tpu", YEARS, step_erf(YEARS), month_engine="xla"))
    out = runner.run(params=runner.batched_params(sweep), out_vars=OUT)
    return runner, {k: np.asarray(v) for k, v in out.items()}


def test_ensemble_matches_jax_runner(sweep, jax_ensemble):
    jax_runner, want = jax_ensemble
    runner = EnsembleRunner(build_udeb("rscm_tpu_torch", YEARS, step_erf(YEARS)), device="cpu")
    params = params_from_jax(
        jax_runner.program.gather_params(), sweep,
        node_names=runner.program.node_names(), device="cpu", dtype=torch.float64,
    )
    got = runner.run(params, out_vars=OUT)
    assert set(got) == set(OUT)
    for name in OUT:
        assert tuple(got[name].shape) == want[name].shape == (5, len(YEARS), want[name].shape[-1])
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-8, atol=1e-9,
                                   err_msg=name)


def test_batched_params_matches_convert(sweep):
    runner = EnsembleRunner(build_udeb("rscm_tpu_torch", YEARS[:4], step_erf(YEARS[:4])),
                            device="cpu")
    own = runner.batched_params(sweep)
    converted = params_from_jax(runner.base_params(), sweep,
                                node_names=runner.program.node_names())
    assert own.keys() == converted.keys()
    for node in own:
        for name, value in own[node].items():
            if np.ndim(value):
                assert torch.equal(value, converted[node][name])
            else:
                assert float(value) == converted[node][name]
    batched, baked = runner._split_params(own)
    assert set(batched[next(iter(batched))]) == {"ecs", "kappa"}
    assert all(isinstance(v, float) for node in baked.values() for v in node.values())


def test_ensemble_input_errors(sweep):
    runner = EnsembleRunner(build_udeb("rscm_tpu_torch", YEARS[:4], step_erf(YEARS[:4])),
                            device="cpu")
    with pytest.raises(KeyError, match="ClimateUDEB.nope"):
        runner.batched_params({"ClimateUDEB.nope": np.ones(3)})
    with pytest.raises(ValueError, match="nothing is batched"):
        runner.run(runner.base_params())
    with pytest.raises(KeyError, match="unknown swept"):
        params_from_jax(runner.base_params(), {"ClimateUDEB.nope": np.ones(3)},
                        node_names=runner.program.node_names())


def ramp_forcing_1pct(years, rf_2xco2, start_year):
    dt = years - start_year
    return rf_2xco2 * np.log(np.where(dt > 0, 1.01**dt, 1.0)) / np.log(2.0)


@pytest.mark.parametrize(
    "name, forcing, extra",
    [
        ("10_full_default", "ramp", {}),
        ("12_efficacy_ar6_1pctco2", "ramp", {"efficacy_apply": 2}),
        ("08_sst_to_sat", "step", {}),
    ],
)
def test_golden_cases_through_port(name, forcing, extra):
    """As tests/regression/test_ocean_udeb.py builds these cases: MAGICC7
    defaults with ECS and the 2xCO2 forcing from the case's config, rtol
    0.1 / atol 1e-6 on the four-box global mean."""
    df, config = load_regression_data("ocean_udeb", name)
    years, expected = get_variable_values(df, "Surface Temperature")
    rf_2xco2 = config.get("core_delq2xco2", 3.71)
    if forcing == "ramp":
        erf = ramp_forcing_1pct(years, rf_2xco2, config.get("startyear", 1850))
    else:
        erf = step_erf(years, rf_2xco2)
    params = {"ecs": config.get("core_climatesensitivity", 3.0), "rf_2xco2": rf_2xco2}
    if extra:
        params["efficacy_apply"] = config.get("rf_efficacy_apply", extra["efficacy_apply"])
    model = build_udeb("rscm_tpu_torch", years, erf, from_bounds=True, **params)
    model.run(device="cpu")
    temp = model.timeseries().get_fourbox_timeseries_by_name("Surface Temperature")
    np.testing.assert_allclose(fourbox_global_mean(temp.values()), expected, rtol=0.1,
                               atol=1e-6, err_msg=name)
