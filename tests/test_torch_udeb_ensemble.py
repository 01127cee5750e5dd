"""Ensembles and the golden MAGICC7 case through the port.

- An ensemble swept over ECS and kappa runs through both packages'
  ``EnsembleRunner``s, the port's parameters carried across from the JAX
  package's with ``rscm_tpu_torch.convert``; bar 1e-8 / atol 1e-9, as
  ``tests/test_udeb_pallas.py`` holds its batched kernel route.
- The golden 10_full_default regression case (and the two other 1pctCO2 /
  short cases of ``tests/regression/test_ocean_udeb.py``) run through the
  port as that file builds them, at its tolerances; the nine step-forcing
  cases (01-07, 09, 11) run at that file's phase bounds, and a float32 run
  of 10_full_default's axis under step forcing stays within the
  reference's 5e-5 scale-relative drift of the float64 run
  (``tests/test_dtype_drift.py``).
- The runner's cached model inputs follow the model: after ``Model.run``
  a new ensemble from ``start_idx=0`` gathers the final internal states,
  as the reference's runner does (``rscm_tpu/parallel/ensemble.py:65-80``).
"""

import numpy as np
import pytest
import torch

from regression.helpers import fourbox_global_mean, get_variable_values, load_regression_data
from rscm_tpu.parallel import EnsembleRunner as JaxEnsembleRunner
from rscm_tpu_torch.convert import params_from_jax
from rscm_tpu_torch.parallel import EnsembleRunner
from rscm_tpu_torch.core.model.program import ModelProgram
from test_torch_support import assert_phased, build_udeb, params_from_config, step_erf

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


def test_runner_regathers_inputs_after_model_run():
    """The reference drops its runner's cached inputs when the model's
    ``(time_index, _state_version)`` changes; after ``Model.run`` both
    runners start the next ensemble from the final internal states."""
    years = YEARS[:20]
    swept = {k: v[:4] for k, v in {
        "ClimateUDEB.ecs": np.array([2.0, 2.5, 3.5, 4.5, 5.0]),
        "ClimateUDEB.kappa": np.array([0.5, 0.8, 1.0, 1.2, 1.4]),
    }.items()}
    jax_model = build_udeb("rscm_tpu", years, step_erf(years), month_engine="xla")
    model = build_udeb("rscm_tpu_torch", years, step_erf(years))
    jax_runner = JaxEnsembleRunner(jax_model)
    runner = EnsembleRunner(model, device="cpu")
    jax_params = jax_runner.batched_params(swept)
    params = runner.batched_params(swept)
    first = runner.run(params, out_vars=OUT)
    jax_runner.run(jax_params, out_vars=OUT)

    jax_model.run()
    model.run(device="cpu")
    with pytest.warns(UserWarning, match="start_idx=0"):
        want = jax_runner.run(jax_params, out_vars=OUT, start_idx=0)
    with pytest.warns(UserWarning, match="start_idx=0"):
        got = runner.run(params, out_vars=OUT, start_idx=0)
    for name in OUT:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-8,
                                   atol=1e-9, err_msg=name)
    # the final ocean state moved the second ensemble away from the first
    assert not torch.allclose(got["Heat Uptake"], first["Heat Uptake"])
    assert runner._inputs_version == (model.time_index, model._state_version) == (19, 1)

    runner.refresh_inputs()
    assert runner._inputs is None


STEP_CASES = [
    ("01_diffusion_only", dict(shock_rtol=1.5e-2, converge_rtol=1.5e-2, final_rtol=1.5e-2)),
    ("02_constant_upwelling", dict(shock_rtol=1.5e-2, converge_rtol=1.5e-2, final_rtol=1.5e-2)),
    ("03_depth_dependent_area", dict(final_rtol=1e-2)),
    ("04_variable_upwelling", {}),
    ("05_temp_dependent_diffusivity", dict(converge_rtol=1.5e-2, final_rtol=1.5e-2)),
    ("06_ground_heat", dict(shock_rtol=5e-2, skip=15, final_rtol=1.5e-2)),
    ("07_interhemispheric_exchange", dict(shock_rtol=1.5e-2, converge_rtol=1.5e-2,
                                          final_rtol=1.5e-2)),
    ("09_time_varying_ecs", dict(final_rtol=1e-2)),
    ("11_efficacy_ar6", dict(final_rtol=1e-2)),
]


@pytest.mark.parametrize("name, bounds", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_golden_step_cases_through_port(name, bounds):
    """As ``tests/regression/test_ocean_udeb.py::run_step_scenario`` builds
    and bounds these cases: ClimateUDEB from the case's config under the
    abrupt-2xCO2 step, phases at that file's bounds (shock rtol 3e-2,
    converge and final 2e-2 unless the case narrows or widens them)."""
    df, config = load_regression_data("ocean_udeb", name)
    years, expected = get_variable_values(df, "Surface Temperature")
    erf = step_erf(years, config.get("core_delq2xco2", 3.71))
    model = build_udeb("rscm_tpu_torch", years, erf, from_bounds=True,
                       **params_from_config(config))
    model.run(device="cpu")
    temp = model.timeseries().get_fourbox_timeseries_by_name("Surface Temperature")
    assert_phased(fourbox_global_mean(temp.values()), expected, atol=1e-6, name=name,
                  **{"shock_rtol": 3e-2, **bounds})


def test_float32_drift_on_golden_axis():
    """A float32 run of the year loop against the float64 run on
    10_full_default's axis under step forcing, each variable's max
    |f32 - f64| over its max |f64|: below the reference's 5e-5
    (``tests/test_dtype_drift.py::test_udeb_f32_drift_default``)."""
    df, config = load_regression_data("ocean_udeb", "10_full_default")
    years, _ = get_variable_values(df, "Surface Temperature")
    erf = step_erf(years, config.get("core_delq2xco2", 3.71))

    def trajectories(dtype):
        model = build_udeb("rscm_tpu_torch", years, erf, from_bounds=True,
                           **params_from_config(config))
        prog = ModelProgram(model, dtype=dtype, device="cpu")
        params = {nk: {pn: float(v) for pn, v in node.items()}
                  for nk, node in prog.gather_params().items()}
        endo, _ = prog.run_fn(prog.gather_endo(1), prog.gather_exo(), params,
                              prog.gather_internals())
        return {k: v.to(torch.float64).numpy() for k, v in endo.items()}

    t64, t32 = trajectories(torch.float64), trajectories(torch.float32)
    assert set(t64) >= {"Surface Temperature", "Heat Uptake"}
    for name, a in t64.items():
        assert t32[name].dtype == np.float64
        scale = np.nanmax(np.abs(a))
        scale = scale if np.isfinite(scale) and scale > 0 else 1.0
        drift = float(np.nanmax(np.abs(a - t32[name])) / scale)
        assert drift < 5e-5, f"{name}: float32 drift {drift:.2e}"
