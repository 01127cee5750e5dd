"""The port's step-by-step executor (``Model.step``, ``Model.run(compiled=
False)``) against ``rscm_tpu``'s host executor on the CPU in float64.

- the counterparts of ``tests/test_model.py:49-163``: warming after one
  ``step()``, outputs at N+1, the two executors agreeing at 1e-12, a run
  continuing after two ``step()`` calls with the committed rows left bit
  for bit;
- a component whose solve raises leaves the same NaN holes and prints the
  same message as the reference, and so does an output that cannot be
  written; ``run()`` chooses its executor up front and does not fall back;
- ``PythonComponent`` on its typed and its legacy dict path, which steps
  under ``run()`` and raises under ``run(compiled=True)``; user code sees
  host values;
- ``step()`` bumps ``_state_version`` and ``EnsembleRunner`` gathers its
  inputs again;
- ClimateUDEB (the four parameter sets of ``tests/test_udeb_traced.py``,
  an endogenous ERF whose first value is NaN, the host layout of its
  state) at 1e-10, the reference's bar between its two executors;
- the MAGICC graph under both ocean-carbon engines through
  ``run(compiled=False)`` at the graph's 1e-9, with OceanCarbon's history
  newest-first after the run.
"""

import importlib

import numpy as np
import pytest
import torch

from test_torch_support import UDEB_OUTPUTS, build_udeb, step_erf, values

TWO_LAYER_PARAMS = dict(
    lambda0=1.0, a=0.0, efficacy=1.0, eta=0.7,
    heat_capacity_surface=8.0, heat_capacity_deep=100.0,
)
TWO_LAYER_OUT = ["Surface Temperature", "Deep Ocean Temperature"]


def build_two_layer(pkg, erf_values, years):
    core = importlib.import_module(f"{pkg}.core")
    components = importlib.import_module(f"{pkg}.components")
    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_component(components.TwoLayer(**TWO_LAYER_PARAMS))
        .with_exogenous_variable(
            "Effective Radiative Forcing", core.Timeseries.from_values(erf_values, years)
        )
        .with_initial_values({"Surface Temperature": 0.0, "Deep Ocean Temperature": 0.0})
        .build()
    )


def temperature(model, index):
    return model.collection.get_data("Surface Temperature").at_scalar(index)


# -- the counterparts of tests/test_model.py ------------------------------------


@pytest.mark.parametrize("level, sign", [(4.0, 1), (-2.0, -1)])
def test_step_warms_or_cools_with_the_forcing(level, sign):
    years = np.arange(2000.0, 2003.0)
    model = build_two_layer("rscm_tpu_torch", np.full(3, level), years)
    model.step(device="cpu")
    t1 = temperature(model, 1)
    assert 0.0 < sign * t1 < abs(level)
    ref = build_two_layer("rscm_tpu", np.full(3, level), years)
    ref.step()
    np.testing.assert_allclose(t1, temperature(ref, 1), rtol=1e-12)


def test_zero_forcing_no_warming_and_linear_response():
    years = np.arange(2000.0, 2003.0)
    model = build_two_layer("rscm_tpu_torch", np.zeros(3), years)
    model.run(compiled=False, device="cpu")
    assert abs(temperature(model, 2)) < 1e-10
    small = build_two_layer("rscm_tpu_torch", np.full(2, 2.0), years[:2])
    large = build_two_layer("rscm_tpu_torch", np.full(2, 4.0), years[:2])
    small.step(device="cpu")
    large.step(device="cpu")
    assert abs(temperature(large, 1) / temperature(small, 1) - 2.0) < 0.1


def test_outputs_written_at_n_plus_1():
    years = np.arange(2000.0, 2005.0)
    model = build_two_layer("rscm_tpu_torch", np.full(5, 3.7), years)
    version = model._state_version
    model.step(device="cpu")
    assert temperature(model, 0) == 0.0
    assert temperature(model, 1) > 0.0
    assert np.isnan(temperature(model, 2))
    assert model.time_index == 1
    assert model._state_version == version + 1


def test_run_completes_monotone_and_finished():
    years = np.arange(2000.0, 2010.0)
    model = build_two_layer("rscm_tpu_torch", np.full(10, 3.7), years)
    assert model.current_time() == 2000.0 and not model.finished()
    model.run(compiled=False, device="cpu")
    assert model.finished()
    ts = model.collection.get_data("Surface Temperature")
    assert ts.latest == 9
    vals = ts.values()[:, 0]
    assert not np.isnan(vals).any()
    assert (np.diff(vals) > 0).all()


@pytest.mark.parametrize("compiled", [True, False], ids=["year_loop", "step_by_step"])
def test_executors_agree_with_each_other_and_jax(compiled):
    years = np.arange(2000.0, 2050.0)
    erf = np.linspace(0.0, 5.0, len(years))
    port = build_two_layer("rscm_tpu_torch", erf, years)
    port.run(compiled=compiled, device="cpu")
    other = build_two_layer("rscm_tpu_torch", erf, years)
    other.run(compiled=not compiled, device="cpu")
    ref = build_two_layer("rscm_tpu", erf, years)
    ref.run(compiled=compiled)
    for name in TWO_LAYER_OUT:
        np.testing.assert_allclose(values(port, name), values(other, name),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(values(port, name), values(ref, name),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


def test_step_then_year_loop_continues():
    years = np.arange(2000.0, 2020.0)
    erf = np.full(len(years), 3.7)
    reference = build_two_layer("rscm_tpu_torch", erf, years)
    reference.run(compiled=False, device="cpu")
    mixed = build_two_layer("rscm_tpu_torch", erf, years)
    mixed.step(device="cpu")
    mixed.step(device="cpu")
    mixed.run(compiled=True, device="cpu")
    np.testing.assert_allclose(values(mixed, "Surface Temperature"),
                               values(reference, "Surface Temperature"), rtol=1e-12)
    ref = build_two_layer("rscm_tpu", erf, years)
    ref.step()
    ref.step()
    ref.run(compiled=True)
    np.testing.assert_allclose(values(mixed, "Surface Temperature"),
                               values(ref, "Surface Temperature"), rtol=1e-12)


def test_year_loop_after_steps_keeps_committed_rows_bitwise():
    years = np.arange(2000.0, 2020.0)
    erf = np.linspace(0.1, 3.7, len(years))
    model = build_two_layer("rscm_tpu_torch", erf, years)
    for _ in range(5):
        model.step(device="cpu")
    committed = {name: np.array(model.collection.get_data(name)._values[:6])
                 for name in TWO_LAYER_OUT}
    model.run(compiled=True, device="cpu")
    for name, before in committed.items():
        np.testing.assert_array_equal(before, model.collection.get_data(name)._values[:6],
                                      err_msg=name)
    assert not np.isnan(values(model, "Surface Temperature")).any()


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    years = np.arange(2000.0, 2003.0)
    model = build_two_layer("rscm_tpu_torch", np.full(3, 1.0), years)
    for call in (model.step, lambda: model.run(compiled=False), model.run):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert model.time_index == 0 and model._state_version == 0


# -- print-and-skip -------------------------------------------------------------


def failing_model(pkg, years, x):
    """A graph whose component raises above a threshold and writes one
    output on the wrong grid."""
    core = importlib.import_module(f"{pkg}.core")
    state = importlib.import_module(f"{pkg}.core.state")

    class Fragile(core.Component, register=False):
        x_in = core.Input("X", unit="1")
        y = core.Output("Y", unit="1")
        z = core.Output("Z", unit="1", grid="FourBox")

        def solve(self, t_current, t_next, inputs):
            value = inputs.x_in.get()
            if float(value) > 2.5:
                raise ValueError(f"X too large at {t_current}")
            return self.Outputs(
                y=value * 2.0,
                z=state.StateValue.hemispheric(state.HemisphericSlice(value, value)),
            )

    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_component(Fragile())
        .with_exogenous_variable("X", core.Timeseries.from_values(x, years))
        .build()
    )


def test_failing_component_leaves_the_references_nan_holes(capsys):
    years = np.arange(2000.0, 2008.0)
    x = np.array([1.0, 2.0, 3.0, 1.5, 4.0, 0.5, 2.0, 1.0])
    ref = failing_model("rscm_tpu", years, x)
    ref.run(compiled=False)
    want_out = capsys.readouterr().out
    port = failing_model("rscm_tpu_torch", years, x)
    port.run(compiled=False, device="cpu")
    got_out = capsys.readouterr().out
    assert got_out == want_out
    assert got_out.count("Solving failed: X too large") == 2
    assert "Failed to set output Z: grid mismatch (2 values for FourBox storage)" in got_out
    np.testing.assert_array_equal(values(port, "Y"), values(ref, "Y"))
    assert np.isnan(values(port, "Y")[[0, 3, 5]]).all()
    assert np.isnan(values(port, "Z")).all()


def test_run_chooses_the_year_loop_up_front():
    """``compiled=None`` takes the year loop for a graph that can run there
    and lets its fault raise, where the reference would fall back to
    stepping and print; ``compiled=False`` prints and skips."""
    years = np.arange(2000.0, 2008.0)
    x = np.full(len(years), 3.0)
    port = failing_model("rscm_tpu_torch", years, x)
    with pytest.raises(ValueError, match="X too large"):
        port.run(device="cpu")
    assert port.time_index == 0


# -- PythonComponent ----------------------------------------------------------------


def typed_python_model(pkg, years, seen):
    core = importlib.import_module(f"{pkg}.core")
    python_component = importlib.import_module(f"{pkg}.core.python_component")

    class Doubler(core.Component, register=False):
        emissions = core.Input("Emissions|CO2", unit="GtCO2")
        concentration = core.Output("Concentrations|CO2", unit="ppm")

        def solve(self, t_current, t_next, inputs):
            start = inputs.emissions.at_start()
            seen.setdefault("types", []).append(type(start).__name__)
            seen["at_end"] = inputs.emissions.at_end()
            return self.Outputs(concentration=start * 2.0)

    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_py_component(python_component.PythonComponent.build(Doubler()))
        .with_exogenous_variable(
            "Emissions|CO2",
            core.Timeseries.from_values(np.linspace(1.0, 5.0, len(years)), years),
        )
        .build()
    )


def legacy_python_model(pkg, years):
    core = importlib.import_module(f"{pkg}.core")
    python_component = importlib.import_module(f"{pkg}.core.python_component")

    class Legacy:
        def definitions(self):
            return [
                core.RequirementDefinition("In", "1", core.RequirementType.Input),
                core.RequirementDefinition("Out", "1", core.RequirementType.Output),
            ]

        def solve(self, t_current, t_next, input_state):
            assert isinstance(input_state, dict)
            assert isinstance(input_state["In"], float)
            return {"Out": input_state["In"] * 10.0 + t_current}

    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_py_component(python_component.PythonComponent.build(Legacy()))
        .with_exogenous_variable(
            "In", core.Timeseries.from_values(np.array([1.0, 2.0, 3.0, 4.0, 5.0]), years)
        )
        .build()
    )


def test_python_component_typed_path_matches_jax():
    years = np.arange(2000.0, 2005.0)
    seen_ref, seen = {}, {}
    ref = typed_python_model("rscm_tpu", years, seen_ref)
    ref.run()
    port = typed_python_model("rscm_tpu_torch", years, seen)
    assert not port._runs_in_loop()
    port.run(device="cpu")  # steps: a PythonComponent cannot run in the year loop
    assert port.finished()
    np.testing.assert_array_equal(values(port, "Concentrations|CO2"),
                                  values(ref, "Concentrations|CO2"))
    assert values(port, "Concentrations|CO2")[1, 0] == 2.0
    # the user's code saw host values, not device tensors, and no at_end
    assert seen["types"] == seen_ref["types"] == ["float64"] * 4
    assert seen["at_end"] is None and seen_ref["at_end"] is None


def test_python_component_legacy_path_matches_jax():
    years = np.arange(2000.0, 2005.0)
    ref = legacy_python_model("rscm_tpu", years)
    ref.run(compiled=False)
    port = legacy_python_model("rscm_tpu_torch", years)
    port.run(compiled=False, device="cpu")
    np.testing.assert_array_equal(values(port, "Out"), values(ref, "Out"))
    assert values(port, "Out")[1, 0] == pytest.approx(50.0 + 2000.0)


def test_python_component_refuses_the_year_loop():
    years = np.arange(2000.0, 2005.0)
    port = legacy_python_model("rscm_tpu_torch", years)
    with pytest.raises(TypeError, match="cannot run in the year loop"):
        port.run(compiled=True, device="cpu")
    assert port.time_index == 0
    ref = legacy_python_model("rscm_tpu", years)
    with pytest.raises(TypeError, match="cannot be traced"):
        ref.run(compiled=True)


# -- the runner's cache --------------------------------------------------------------


def test_runner_regathers_inputs_after_step():
    from rscm_tpu.parallel import EnsembleRunner as JaxEnsembleRunner
    from rscm_tpu_torch.parallel import EnsembleRunner

    years = np.arange(1850.0, 1866.0)
    swept = {"ClimateUDEB.ecs": np.array([2.0, 3.0, 4.5]),
             "ClimateUDEB.kappa": np.array([0.5, 1.0, 1.4])}
    jax_model = build_udeb("rscm_tpu", years, step_erf(years), month_engine="xla")
    model = build_udeb("rscm_tpu_torch", years, step_erf(years))
    jax_runner, runner = JaxEnsembleRunner(jax_model), EnsembleRunner(model, device="cpu")
    jax_params, params = jax_runner.batched_params(swept), runner.batched_params(swept)
    first = runner.run(params, out_vars=UDEB_OUTPUTS, start_idx=3)
    jax_runner.run(jax_params, out_vars=UDEB_OUTPUTS, start_idx=3)
    for _ in range(3):
        jax_model.step()
        model.step(device="cpu")
    want = jax_runner.run(jax_params, out_vars=UDEB_OUTPUTS, start_idx=3)
    got = runner.run(params, out_vars=UDEB_OUTPUTS, start_idx=3)
    for name in UDEB_OUTPUTS:  # the rows the runs computed
        np.testing.assert_allclose(got[name][:, 4:].numpy(), np.asarray(want[name])[:, 4:],
                                   rtol=1e-8, atol=1e-9, err_msg=name)
    # the stepped ocean state moved the second ensemble away from the first
    assert not torch.allclose(got["Heat Uptake"], first["Heat Uptake"])
    assert runner._inputs_version == (model.time_index, model._state_version) == (3, 3)


# -- ClimateUDEB ------------------------------------------------------------------------


UDEB_YEARS = np.arange(1850.0, 1930.0)  # 80 years


@pytest.mark.parametrize(
    "params",
    [
        {},
        {"efficacy_apply": 2},
        {"w_variable_fraction": 0.0, "feedback_cumt_sensitivity": 0.0,
         "feedback_q_sensitivity": 0.0},
        {"land_heat_capacity_enabled": False},
    ],
    ids=["defaults", "efficacy_apply_2", "constant_feedbacks", "no_land_heat_capacity"],
)
def test_udeb_step_by_step_matches_jax_host(params):
    erf = step_erf(UDEB_YEARS)
    ref = build_udeb("rscm_tpu", UDEB_YEARS, erf, **params)
    ref.run(compiled=False)
    port = build_udeb("rscm_tpu_torch", UDEB_YEARS, erf, **params)
    port.run(compiled=False, device="cpu")
    for name in UDEB_OUTPUTS:
        got = values(port, name)
        assert np.isfinite(got[1:]).all(), name
        np.testing.assert_allclose(got, values(ref, name), rtol=1e-10,
                                   atol=1e-12 if name == "Surface Temperature" else 1e-10,
                                   err_msg=name)


@pytest.mark.parametrize(
    "widths", [[1.0] * 30, [1.0, 2.0, 1.0, 1.0, 2.0, 2.0] * 5], ids=["uniform", "non_uniform"]
)
def test_udeb_feedback_window_walks_the_step_widths(widths):
    """A 5.5-year feedback window over 1- and 2-year steps: the last entry
    in the window counts in part, as the reference's host path weights it."""
    years = 1850.0 + np.concatenate([[0.0], np.cumsum(widths)])
    erf = step_erf(years)
    ref = build_udeb("rscm_tpu", years, erf, feedback_cumt_period=5.5)
    ref.run(compiled=False)
    port = build_udeb("rscm_tpu_torch", years, erf, feedback_cumt_period=5.5)
    port.run(compiled=False, device="cpu")
    for name in UDEB_OUTPUTS:
        got = values(port, name)
        assert np.isfinite(got[1:]).all(), name
        np.testing.assert_allclose(got, values(ref, name), rtol=1e-10, atol=1e-12,
                                   err_msg=name)


def udeb_with_endogenous_erf(pkg, years, erf):
    """ClimateUDEB whose ERF is a schema aggregate: its value at the first
    step's start is never written, so it is NaN there."""
    core = importlib.import_module(f"{pkg}.core")
    magicc = importlib.import_module(f"{pkg}.magicc")
    schema = core.VariableSchema()
    schema.add_variable("Effective Radiative Forcing|Exogenous", "W/m^2")
    schema.add_aggregate("Effective Radiative Forcing", "W/m^2", "Sum",
                         ["Effective Radiative Forcing|Exogenous"])
    schema.add_variable("Surface Temperature", "K", core.GridType.FourBox)
    for name, unit in [("Heat Uptake", "W/m^2"), ("Ocean Heat Content", "J/m^2"),
                       ("Sea Surface Temperature", "K")]:
        schema.add_variable(name, unit)
    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_schema(schema)
        .with_component(magicc.ClimateUDEB())
        .with_exogenous_variable("Effective Radiative Forcing|Exogenous",
                                 core.Timeseries.from_values(erf, years))
        .with_initial_values({"Surface Temperature": 0.0})
        .build()
    )


def test_udeb_nan_first_erf_falls_back_to_the_step_end():
    years = np.arange(1850.0, 1870.0)
    erf = np.linspace(0.5, 3.0, len(years))
    ref = udeb_with_endogenous_erf("rscm_tpu", years, erf)
    ref.run(compiled=False)
    port = udeb_with_endogenous_erf("rscm_tpu_torch", years, erf)
    port.run(compiled=False, device="cpu")
    assert np.isnan(values(port, "Effective Radiative Forcing")[0, 0])
    for name in UDEB_OUTPUTS:
        got = values(port, name)
        assert np.isfinite(got[1:]).all(), name
        np.testing.assert_allclose(got, values(ref, name), rtol=1e-10, atol=1e-12,
                                   err_msg=name)


def test_udeb_state_after_step_has_the_host_layout():
    years = np.arange(1850.0, 1870.0)
    erf = step_erf(years)
    ref = build_udeb("rscm_tpu", years, erf)
    port = build_udeb("rscm_tpu_torch", years, erf)
    for _ in range(6):
        ref.step()
        port.step(device="cpu")
    node = port.exec_order[-1]
    want, got = ref.component_states[node], port.component_states[node]
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert type(g) is type(w) or (isinstance(g, np.ndarray) and isinstance(w, np.ndarray)), key
        assert np.shape(g) == np.shape(w), key
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12, err_msg=key)
    # newest-first: this year's entry leads the cumulative-temperature history
    assert got["th_values"][0] != 0.0 and got["th_values"][6] == 0.0
    # and the year loop continues from it
    port.run(compiled=True, device="cpu")
    ref.run(compiled=False)
    for name in UDEB_OUTPUTS:
        np.testing.assert_allclose(values(port, name), values(ref, name), rtol=1e-10,
                                   atol=1e-10, err_msg=name)


# -- the MAGICC graph ----------------------------------------------------------------


MAGICC_YEARS = np.arange(1850.0, 1876.0)


def trajectories(model):
    return {item.name: np.asarray(model.collection.get_data(item.name).values())
            for item in model.collection}


@pytest.mark.parametrize("engine", ["ring", "expsum"])
def test_magicc_graph_step_by_step_matches_jax_host(engine):
    from rscm_tpu.magicc.coupled import build_magicc_model as jax_build
    from rscm_tpu_torch.magicc.coupled import build_magicc_model

    ref = jax_build(years=MAGICC_YEARS, ocean_params={"engine": engine})
    ref.run(compiled=False)
    port = build_magicc_model(years=MAGICC_YEARS, ocean_params={"engine": engine})
    port.run(compiled=False, device="cpu")
    want, got = trajectories(ref), trajectories(port)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=1e-9, atol=1e-12, err_msg=name)
    assert np.isfinite(got["Atmospheric Concentration|CO2"]).all()
    ocean = next(n for n in port.exec_order
                 if type(port.graph.nodes[n]).__name__ == "OceanCarbon")
    assert port.graph.nodes[ocean].resolved_engine() == engine
    # the history after the run is newest-first, as the reference's
    want_state, got_state = ref.component_states[ocean], port.component_states[ocean]
    assert set(got_state) == set(want_state)
    for key in want_state:
        assert np.shape(got_state[key]) == np.shape(want_state[key]), key
        np.testing.assert_allclose(got_state[key], want_state[key], rtol=1e-9, atol=1e-15,
                                   err_msg=key)
    assert got_state["flux_history"][0] != 0.0
