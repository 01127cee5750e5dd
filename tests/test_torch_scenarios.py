"""Batched exogenous scenarios through the port's ``EnsembleRunner.run``.

``exo={name: (B, n_steps, g)}`` gives every member its own series (one
emission pathway per member), in the JAX package's layout; the port reads
it through an ``(n_steps, B, g)`` view.  Held against ``rscm_tpu``'s
runner at 1e-8 in float64:

- ``tests/test_ensemble.py``'s two forcing scenarios on the two-layer
  model (double forcing, double response);
- ``tests/test_ssp_ensemble.py``'s parameter x scenario cross product at
  2 members x 8 scenarios, with its gates: finite values, every member
  warmer under the highest pathway than under the lowest, concentrations
  above pre-industrial, and one (scenario, member) pair against a single
  run of the port at 1e-10;
- a batch given by ``exo`` alone, numpy and tensor ``exo``, and the
  streamed runs bit-equal to ``stream=False``.

Also the runner's refusals (a batch-size mismatch, an unknown or
misshapen scenario, ``mesh=``), ``stack_params``, and the window reads of a
batched variable (``(B,)``, members differing) beside a shared one (0-d).
"""

import importlib

import numpy as np
import pytest
import torch

from rscm_tpu.parallel import EnsembleRunner as JaxEnsembleRunner
from rscm_tpu_torch.core.interpolate import LinearSpline
from rscm_tpu_torch.core.spatial import GridType
from rscm_tpu_torch.core.state import ScalarWindow, Trajectory, VariableSource, make_window
from rscm_tpu_torch.parallel import EnsembleRunner, stack_params

#: ``tests/test_model.py``'s two-layer parameters
TWO_LAYER_PARAMS = dict(lambda0=1.0, a=0.0, efficacy=1.0, eta=0.7,
                        heat_capacity_surface=8.0, heat_capacity_deep=100.0)
ERF = "Effective Radiative Forcing"
EMIS = "Emissions|CO2|Anthropogenic"


def two_layer(pkg, years, erf):
    """``tests/test_ensemble.py::build_model`` in package ``pkg``."""
    core = importlib.import_module(f"{pkg}.core")
    components = importlib.import_module(f"{pkg}.components")
    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_component(components.TwoLayer(**TWO_LAYER_PARAMS))
        .with_exogenous_variable(ERF, core.Timeseries.from_values(erf, years))
        .with_initial_values({"Surface Temperature": 0.0, "Deep Ocean Temperature": 0.0})
        .build()
    )


def coupled(pkg, years, emissions):
    """``tests/test_ssp_ensemble.py::build_coupled`` in package ``pkg``."""
    core = importlib.import_module(f"{pkg}.core")
    components = importlib.import_module(f"{pkg}.components")
    schema = core.VariableSchema()
    for name, unit in [
        (EMIS, "GtC / yr"),
        ("Surface Temperature", "K"),
        ("Deep Ocean Temperature", "K"),
        ("Atmospheric Concentration|CO2", "ppm"),
        ("Cumulative Emissions|CO2", "Gt C"),
        ("Cumulative Land Uptake", "Gt C"),
        ("Effective Radiative Forcing|CO2", "W/m^2"),
    ]:
        schema.add_variable(name, unit)
    schema.add_aggregate(ERF, "W/m^2", "Sum", ["Effective Radiative Forcing|CO2"])
    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_schema(schema)
        .with_component(components.CarbonCycle(tau=30.0, conc_pi=278.0, alpha_temperature=0.03))
        .with_component(components.CO2ERF(erf_2xco2=3.93, conc_pi=278.0))
        .with_component(components.TwoLayer(**TWO_LAYER_PARAMS))
        .with_exogenous_variable(EMIS, core.Timeseries.from_values(emissions, years))
        .with_initial_values({
            "Surface Temperature": 0.0,
            "Deep Ocean Temperature": 0.0,
            "Atmospheric Concentration|CO2": 278.0,
            "Cumulative Emissions|CO2": 0.0,
            "Cumulative Land Uptake": 0.0,
        })
        .build()
    )


def ssp_like_scenarios(years, n_scenarios=8):
    """``tests/test_ssp_ensemble.py::make_ssp_like_scenarios``: pathways from
    strong mitigation to high growth, ``(S, n_years, 1)``."""
    ramp = np.linspace(0.0, 1.0, len(years))
    peaks = np.linspace(2.0, 30.0, n_scenarios)
    declines = np.linspace(0.9, 0.0, n_scenarios)
    scenarios = []
    for peak, decline in zip(peaks, declines):
        path = peak * np.sin(np.pi * np.clip(ramp / (1.0 - 0.4 * decline), 0, 1))
        scenarios.append(np.maximum(path, 0.0)[:, None])
    return np.stack(scenarios)


def assert_matches_jax(got, want, rtol=1e-8):
    assert set(got) == set(want)
    for name in want:
        w = np.asarray(want[name])
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=rtol, atol=1e-10, err_msg=name)


def runners(build):
    return EnsembleRunner(build("rscm_tpu_torch"), device="cpu"), JaxEnsembleRunner(build("rscm_tpu"))


# -- the JAX package's scenario tests ---------------------------------------

def test_forcing_scenarios_match_jax():
    years = np.arange(2000.0, 2020.0)
    port, ref = runners(lambda pkg: two_layer(pkg, years, np.zeros(len(years))))
    scenarios = np.stack([np.full((len(years), 1), 2.0), np.full((len(years), 1), 4.0)])
    swept = {"TwoLayer.lambda0": np.array([1.0, 1.0])}
    out = port.run(port.batched_params(swept), exo={ERF: scenarios},
                   out_vars=["Surface Temperature"])
    temps = out["Surface Temperature"].numpy()
    np.testing.assert_allclose(temps[1, -1], 2.0 * temps[0, -1], rtol=1e-10)
    assert_matches_jax(out, ref.run(ref.batched_params(swept), exo={ERF: scenarios},
                                    out_vars=["Surface Temperature"]))


def test_parameter_by_scenario_cross_product_matches_jax():
    years = np.arange(2000.0, 2101.0)
    n_members, n_scenarios = 2, 8
    scenarios = ssp_like_scenarios(years, n_scenarios)
    port, ref = runners(lambda pkg: coupled(pkg, years, np.zeros(len(years))))
    rng = np.random.default_rng(0)
    member_params = {
        "TwoLayer.lambda0": rng.uniform(0.8, 1.8, n_members),
        "CarbonCycle.tau": rng.uniform(15.0, 60.0, n_members),
    }
    swept = {k: np.tile(v, n_scenarios) for k, v in member_params.items()}
    exo = {EMIS: np.repeat(scenarios, n_members, axis=0)}
    out_vars = ["Surface Temperature", "Atmospheric Concentration|CO2"]
    out = port.run(port.batched_params(swept), exo=exo, out_vars=out_vars)
    assert_matches_jax(out, ref.run(ref.batched_params(swept), exo=exo, out_vars=out_vars))

    temps = out["Surface Temperature"].numpy().reshape(n_scenarios, n_members, len(years))
    conc = out["Atmospheric Concentration|CO2"].numpy().reshape(
        n_scenarios, n_members, len(years))
    assert np.all(np.isfinite(temps[:, :, 1:]))
    assert np.all(temps[-1, :, -1] > temps[0, :, -1])
    assert np.all(conc[:, :, 1:] >= 277.9)

    s, m = 5, 1
    single = coupled("rscm_tpu_torch", years, scenarios[s, :, 0])
    for comp in single.graph.nodes:
        if type(comp).__name__ == "TwoLayer":
            comp.lambda0 = float(member_params["TwoLayer.lambda0"][m])
        if type(comp).__name__ == "CarbonCycle":
            comp.tau = float(member_params["CarbonCycle.tau"][m])
    single.run(device="cpu")
    expected = single.collection.get_data("Surface Temperature").values()[:, 0]
    np.testing.assert_allclose(temps[s, m], expected, rtol=1e-10, atol=1e-12)


def test_exo_only_batch_matches_jax():
    """A batch given by the scenarios alone, every parameter shared."""
    years = np.arange(2000.0, 2041.0)
    port, ref = runners(lambda pkg: coupled(pkg, years, np.zeros(len(years))))
    exo = {EMIS: ssp_like_scenarios(years, 4)}
    out = port.run(port.base_params(), exo=exo)
    assert set(out) == set(port.program.endo_names)
    assert all(tuple(v.shape[:2]) == (4, len(years)) for v in out.values())
    assert_matches_jax(out, ref.run(ref.base_params(), exo=exo))


def test_numpy_and_tensor_scenarios_and_both_loops_agree_bit_for_bit():
    years = np.arange(2000.0, 2031.0)
    runner = EnsembleRunner(coupled("rscm_tpu_torch", years, np.zeros(len(years))), device="cpu")
    scenarios = ssp_like_scenarios(years, 3)
    params = runner.batched_params({"TwoLayer.lambda0": np.array([0.9, 1.2, 1.6])})
    full = runner.run(params, exo={EMIS: scenarios}, stream=False)
    for exo in (scenarios, torch.tensor(scenarios)):
        streamed = runner.run(params, exo={EMIS: exo}, out_vars=list(full))
        for name, values in full.items():
            assert torch.equal(streamed[name].nan_to_num(-1.0), values.nan_to_num(-1.0)), name
    # a shared (n_steps, g) series in place of the model's own
    shared = runner.run(params, exo={EMIS: scenarios[1]}, out_vars=["Surface Temperature"])
    torch.testing.assert_close(shared["Surface Temperature"][1],
                               full["Surface Temperature"][1], rtol=0, atol=0)


# -- refusals and stack_params --------------------------------------------

def test_refusals():
    years = np.arange(2000.0, 2011.0)
    runner = EnsembleRunner(coupled("rscm_tpu_torch", years, np.zeros(len(years))), device="cpu")
    three = runner.batched_params({"TwoLayer.lambda0": np.array([0.9, 1.2, 1.6])})
    with pytest.raises(ValueError, match="disagree on B"):
        runner.run(three, exo={EMIS: ssp_like_scenarios(years, 2)})
    with pytest.raises(ValueError, match="nothing is batched"):
        runner.run(runner.base_params())
    with pytest.raises(KeyError, match="not an exogenous variable"):
        runner.run(three, exo={"Surface Temperature": ssp_like_scenarios(years, 3)})
    with pytest.raises(ValueError, match="steps"):
        runner.run(three, exo={EMIS: ssp_like_scenarios(years, 3)[:, :-1]})
    with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
        runner.run(three, mesh=object())


def test_stack_params_builds_the_batch():
    years = np.arange(2000.0, 2021.0)
    runner = EnsembleRunner(two_layer("rscm_tpu_torch", years, np.full(len(years), 3.7)),
                            device="cpu")
    base = runner.base_params()
    lambdas = [0.8, 1.1, 1.9]
    members = []
    for lam in lambdas:
        member = {nk: dict(node) for nk, node in base.items()}
        (nk,) = member
        member[nk]["lambda0"] = np.float64(lam)
        members.append(member)
    stacked = stack_params(members)
    assert stacked[nk]["lambda0"].shape == (3,)
    assert stacked[nk]["eta"].shape == (3,)
    got = runner.run(stacked, out_vars=["Surface Temperature"])
    want = runner.run(runner.batched_params({"TwoLayer.lambda0": np.array(lambdas)}),
                      out_vars=["Surface Temperature"])
    assert torch.equal(got["Surface Temperature"], want["Surface Temperature"])
    tensors = stack_params([{nk: {"lambda0": torch.tensor(lam, dtype=torch.float64)}}
                            for lam in lambdas])
    assert isinstance(tensors[nk]["lambda0"], torch.Tensor)
    np.testing.assert_array_equal(tensors[nk]["lambda0"].numpy(), lambdas)


# -- window reads -----------------------------------------------------------

def test_window_reads_of_batched_and_shared_variables():
    """A batched variable (scenario view or trajectory) reads ``(B,)`` with
    its members' own values; shared data reads 0-d."""
    n, b = 6, 3
    times = np.arange(2000.0, 2000.0 + n)
    data = torch.tensor(np.random.default_rng(1).normal(size=(b, n, 1)))
    batched = data.transpose(0, 1)  # (n_steps, B, g), as run() hands it on
    shared = data[0]
    traj = Trajectory(list(batched.unbind(0)))
    idx = 3

    def window(values, source=VariableSource.Exogenous):
        return make_window(GridType.Scalar, values, idx, times[idx], source=source,
                           strategy=LinearSpline(True), time_values=times)

    for values in (batched, traj):
        w = window(values)
        assert isinstance(w, ScalarWindow)
        for read, row in ((w.at_start(), idx), (w.previous(), idx - 1),
                          (w.at_end(), idx + 1), (w.at_offset(-2), idx - 2)):
            assert tuple(read.shape) == (b,)
            torch.testing.assert_close(read, data[:, row, 0], rtol=0, atol=0)
        assert tuple(w.last_n(3).shape) == (b, 3)
        torch.testing.assert_close(w.last_n(3), data[:, idx - 2: idx + 1, 0], rtol=0, atol=0)
        mid = w.interpolate(times[idx] + 0.25)
        torch.testing.assert_close(
            mid, data[:, idx, 0] + 0.25 * (data[:, idx + 1, 0] - data[:, idx, 0]))
        upstream = window(values, VariableSource.UpstreamOutput)
        torch.testing.assert_close(upstream.get(), data[:, idx + 1, 0], rtol=0, atol=0)
    assert len(set(window(batched).at_start().tolist())) == b  # the members differ

    w = window(shared)
    for read in (w.at_start(), w.previous(), w.get(), w.interpolate(times[idx] + 0.5)):
        assert tuple(read.shape) == ()
    torch.testing.assert_close(w.at_start(), shared[idx, 0], rtol=0, atol=0)
