"""The streaming loop (``ModelProgram.run_window_fn``) through the port.

The streaming loop keeps, for every variable that is not emitted, only the
rows a reader can still reach; every read is the same operation on the
same row as in the full loop, so the port's streamed trajectories equal
its own ``stream=False`` ones bit for bit.  Against the JAX package's
``run_window_fn`` they agree at 1e-9 (one member) and 1e-8 (an ensemble,
through both packages' ``EnsembleRunner.run``), in float64:

- the ClimateUDEB model and the ten-component MAGICC graph;
- N2O chemistry, which reads its concentration two and four steps back
  (``N2OChemistry.input_lookback``);
- two random graphs of deep-lookback readers, integrators, grid producers
  and aggregates (``tests/test_fuzz_graphs.py``'s builder, rebuilt with the
  port's classes);
- an endogenous variable the builder pre-populated and no component
  writes, which keeps its stored rows;
- a start at the model's last index, and the ``KeyError`` for a name that
  is not endogenous.

Also: ``ModelProgram`` follows the entry points' device rule (the CUDA card,
raising without one), and the calibration runner streams by default with
the full loop's values.
"""

import importlib
import inspect
import random

import numpy as np
import pytest
import torch

import test_fuzz_graphs as fuzz
from test_torch_support import build_flagship, build_udeb, step_erf
from rscm_tpu.core.model.program import ModelProgram as JaxModelProgram
from rscm_tpu.parallel import EnsembleRunner as JaxEnsembleRunner
from rscm_tpu_torch.core.model.program import ModelProgram
from rscm_tpu_torch.parallel import EnsembleRunner

def host_params(program):
    return {nk: {pn: float(v) for pn, v in node.items()}
            for nk, node in program.gather_params().items()}


def port_single(model, out_vars, stream=True, start_idx=0):
    """One member through the port's loop, ``{name: (n_steps, g)}``."""
    p = ModelProgram(model, device="cpu")
    args = (p.gather_exo(), host_params(p), p.gather_internals())
    if stream:
        out, _ = p.run_window_fn(p.gather_endo_window(1, start_idx), *args, out_vars,
                                 start_idx=start_idx)
    else:
        out, _ = p.run_fn(p.gather_endo(1), *args, start_idx=start_idx)
    return {name: out[name][:, 0].numpy() for name in out_vars}


def jax_single(model, out_vars, start_idx=0):
    """One member through the JAX package's ``run_window_fn``."""
    p = JaxModelProgram(model)
    out, _ = p.run_window_fn(p.gather_endo_window(start_idx), p.gather_exo(),
                             p.gather_params(), p.gather_internals(), out_vars,
                             start_idx=start_idx)
    return {name: np.asarray(out[name]) for name in out_vars}


def assert_bit_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        a = got[name].numpy() if isinstance(got[name], torch.Tensor) else got[name]
        b = want[name].numpy() if isinstance(want[name], torch.Tensor) else want[name]
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def assert_single_matches_jax(build, out_vars):
    """Streamed one member: bit-equal to the full loop, 1e-9 to JAX."""
    streamed = port_single(build("rscm_tpu_torch"), out_vars)
    assert_bit_equal(streamed, port_single(build("rscm_tpu_torch"), out_vars, stream=False))
    want = jax_single(build("rscm_tpu"), out_vars)
    for name in out_vars:
        np.testing.assert_allclose(streamed[name], want[name], rtol=1e-9, atol=1e-12,
                                   err_msg=name)


def assert_ensemble_matches_jax(build, swept, out_vars):
    """Streamed ensemble: bit-equal to ``stream=False``, 1e-8 to JAX."""
    runner = EnsembleRunner(build("rscm_tpu_torch"), device="cpu")
    params = runner.batched_params(swept)
    streamed = runner.run(params, out_vars=out_vars)
    full = runner.run(params, stream=False)
    assert_bit_equal(streamed, {name: full[name] for name in out_vars})
    jax_runner = JaxEnsembleRunner(build("rscm_tpu"))
    want = jax_runner.run(jax_runner.batched_params(swept), out_vars=out_vars)
    for name in out_vars:
        np.testing.assert_allclose(streamed[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-8, atol=1e-10, err_msg=name)


# -- models ----------------------------------------------------------------

UDEB_YEARS = np.arange(1850.0, 1901.0)
UDEB_OUT = ["Surface Temperature", "Heat Uptake", "Ocean Heat Content"]


def udeb(pkg):
    return build_udeb(pkg, UDEB_YEARS, step_erf(UDEB_YEARS))


MAGICC_YEARS = np.arange(1850.0, 1881.0)
MAGICC_OUT = ["Surface Temperature", "Atmospheric Concentration|CO2",
              "Atmospheric Concentration|N2O", "Carbon Flux|Ocean"]


def magicc(pkg):
    return importlib.import_module(f"{pkg}.magicc.coupled").build_magicc_model(
        years=MAGICC_YEARS)


def n2o_model(pkg, delay):
    """``tests/test_streaming.py``'s N2O graph (``strat_delay`` ``delay``)."""
    core = importlib.import_module(f"{pkg}.core")
    magicc_pkg = importlib.import_module(f"{pkg}.magicc")
    years = np.arange(2000.0, 2030.0)
    emissions = 8.0 + 3.0 * np.sin((years - 2000.0) / 4.0)
    schema = core.VariableSchema()
    schema.add_variable("Emissions|N2O", "Mt N/yr")
    schema.add_variable("Atmospheric Concentration|N2O", "ppb")
    schema.add_variable("Lifetime|N2O", "yr")
    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_schema(schema)
        .with_component(magicc_pkg.N2OChemistry(strat_delay=delay))
        .with_exogenous_variable("Emissions|N2O", core.Timeseries.from_values(emissions, years))
        .with_initial_values({"Atmospheric Concentration|N2O": 275.0})
        .build()
    )


#: the JAX fuzz suite's graph builders, rebuilt against the port's classes
_FUZZ_FUNCTIONS = ("_make_affine_component", "_make_integrator_component",
                   "_make_fourbox_component", "_make_global_reader",
                   "_make_lookback_component", "_random_streaming_model")


def _port_fuzz_namespace():
    from rscm_tpu_torch.core import ModelBuilder, TimeAxis, Timeseries, VariableSchema
    from rscm_tpu_torch.core.component import Component, Input, Output, Parameter, State

    ns = dict(random=random, np=np, ModelBuilder=ModelBuilder, TimeAxis=TimeAxis,
              Timeseries=Timeseries, VariableSchema=VariableSchema, Component=Component,
              Input=Input, Output=Output, Parameter=Parameter, State=State)
    source = "\n\n".join(inspect.getsource(getattr(fuzz, f)) for f in _FUZZ_FUNCTIONS)
    exec(source.replace("rscm_tpu.", "rscm_tpu_torch."), ns)
    return ns


def random_graph(pkg, seed):
    build = (fuzz._random_streaming_model if pkg == "rscm_tpu"
             else _port_fuzz_namespace()["_random_streaming_model"])
    return build(seed)


def prefilled(pkg):
    """``tests/test_streaming.py``'s graph: ``Extra`` is declared by a
    component that never writes it, and its stored rows are pre-populated."""
    core = importlib.import_module(f"{pkg}.core")
    comp = importlib.import_module(f"{pkg}.core.component")

    class PartialWriter(comp.Component, register=False):
        drive = comp.Input("Drive", unit="K")
        main = comp.Output("Main", unit="K")
        extra = comp.Output("Extra", unit="K")  # declared, never written

        def solve_ctx(self, ctx, inputs, internal_state):
            return {"Main": inputs.drive.get() * 2.0}, internal_state

    class Reader(comp.Component, register=False):
        extra = comp.Input("Extra", unit="K")
        echo = comp.Output("Echo", unit="K")

        def solve_ctx(self, ctx, inputs, internal_state):
            return {"Echo": inputs.extra.get() + 1.0}, internal_state

    years = np.arange(2000.0, 2012.0)
    model = (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_component(PartialWriter())
        .with_component(Reader())
        .with_exogenous_variable(
            "Drive", core.Timeseries.from_values(np.linspace(0.0, 2.0, 12), years))
        .build()
    )
    model.collection.get_data("Extra")._values[:, 0] = np.linspace(5.0, 7.0, len(years))
    return model


# -- tests -----------------------------------------------------------------

def test_udeb_single_member_matches_jax():
    assert_single_matches_jax(udeb, UDEB_OUT)


def test_udeb_ensemble_matches_jax():
    rng = np.random.default_rng(5)
    assert_ensemble_matches_jax(udeb, {"ClimateUDEB.ecs": rng.uniform(1.8, 5.5, 6),
                                       "ClimateUDEB.kappa": rng.uniform(0.4, 1.5, 6)}, UDEB_OUT)


def test_magicc_single_member_matches_jax():
    assert_single_matches_jax(magicc, MAGICC_OUT)


def test_magicc_ensemble_matches_jax():
    rng = np.random.default_rng(3)
    assert_ensemble_matches_jax(magicc, {"ClimateUDEB.ecs": rng.uniform(1.8, 5.5, 4),
                                         "TerrestrialCarbon.beta": rng.uniform(0.3, 0.9, 4)},
                                MAGICC_OUT)


@pytest.mark.parametrize("delay", [1, 3])
def test_deep_lookback_matches_jax(delay):
    build = lambda pkg: n2o_model(pkg, delay)  # noqa: E731
    name = "Atmospheric Concentration|N2O"
    assert ModelProgram(build("rscm_tpu_torch"), device="cpu").lookbacks[name] == delay + 1
    assert_single_matches_jax(build, [name, "Lifetime|N2O"])
    assert_ensemble_matches_jax(
        build, {"N2OChemistry.natural_emissions": np.array([10.0, 12.0, 9.0])}, [name])


#: seeds 0 and 4 are the JAX fuzz suite's seeds (of 0-11) whose graphs read
#: an endogenous variable more than one step back
@pytest.mark.parametrize("seed", [0, 4])
def test_random_graph_matches_jax(seed):
    model, out_vars = random_graph("rscm_tpu_torch", seed)
    lookbacks = ModelProgram(model, device="cpu").lookbacks
    assert lookbacks == JaxModelProgram(random_graph("rscm_tpu", seed)[0]).lookbacks
    assert max(lookbacks.values()) > 1
    assert_single_matches_jax(lambda pkg: random_graph(pkg, seed)[0], out_vars)


def test_prefilled_unwritten_variable_keeps_its_rows():
    out_vars = ["Main", "Extra", "Echo"]
    streamed = port_single(prefilled("rscm_tpu_torch"), out_vars)
    assert_bit_equal(streamed, port_single(prefilled("rscm_tpu_torch"), out_vars, stream=False))
    np.testing.assert_array_equal(streamed["Extra"][:, 0], np.linspace(5.0, 7.0, 12))
    np.testing.assert_array_equal(streamed["Echo"][1:, 0], np.linspace(5.0, 7.0, 12)[1:] + 1.0)
    want = jax_single(prefilled("rscm_tpu"), out_vars)
    for name in out_vars:
        np.testing.assert_allclose(streamed[name], want[name], rtol=1e-12, err_msg=name)
    # streaming only "Echo" releases the unwritten variable's old rows, and
    # its reads still see the stored ones
    only = port_single(prefilled("rscm_tpu_torch"), ["Echo"])
    np.testing.assert_array_equal(only["Echo"], streamed["Echo"])


def test_start_at_last_index_returns_the_stored_run():
    model = build_flagship("rscm_tpu_torch", np.arange(2000.0, 2010.0))
    model.run(compiled=False, device="cpu")
    start = model.time_index
    assert start == 9
    got = port_single(model, ["Surface Temperature"], start_idx=start)
    np.testing.assert_array_equal(
        got["Surface Temperature"], model.collection.get_data("Surface Temperature")._values)


def test_start_mid_run_matches_full_loop():
    """Rows up to ``start_idx`` come from the stored (stepped) history."""
    years = np.arange(2000.0, 2020.0)
    out_vars = ["Surface Temperature", "Atmospheric Concentration|CO2"]
    runs = []
    for stream in (True, False):
        model = build_flagship("rscm_tpu_torch", years)
        for _ in range(4):
            model.step(device="cpu")
        runs.append(port_single(model, out_vars, stream=stream, start_idx=4))
    assert_bit_equal(*runs)


def test_unknown_out_var_raises():
    p = ModelProgram(build_flagship("rscm_tpu_torch", np.arange(2000.0, 2005.0)), device="cpu")
    with pytest.raises(KeyError, match="not endogenous"):
        p.run_window_fn(p.gather_endo_window(1), p.gather_exo(), host_params(p),
                        p.gather_internals(), ["Effective Radiative Forcing|Nope"])


def test_streamed_rows_are_released():
    """A variable that is not emitted keeps only ``lookback + 2`` live rows
    ahead of the written ones, and a read past its lookback raises."""
    model = build_flagship("rscm_tpu_torch", np.arange(2000.0, 2030.0))
    p = ModelProgram(model, device="cpu")
    window = p.gather_endo_window(3, 10)
    for name, rows in window.items():
        assert tuple(rows.shape) == (p.lookbacks[name] + 2, 3, 1), name
    _, (final, _) = p.run_window_fn(p.gather_endo_window(1), p.gather_exo(),
                                    host_params(p), p.gather_internals(),
                                    ["Surface Temperature"])
    for name, rows in final.items():
        assert tuple(rows.shape) == (p.lookbacks[name] + 2, 1, 1), name
    from rscm_tpu_torch.core.state import Trajectory

    traj = Trajectory(list(torch.zeros(5, 2, 1).unbind(0)))
    traj.release(1)
    with pytest.raises(IndexError, match="input_lookback"):
        traj[1]


def test_model_program_device_follows_the_entry_point_rule():
    """``ModelProgram`` runs on the CUDA card by default and raises without
    one, like every other entry point; ``device="cpu"`` runs."""
    model = build_flagship("rscm_tpu_torch", np.arange(2000.0, 2006.0))
    if torch.cuda.is_available():
        assert ModelProgram(model).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ModelProgram(model)
    p = ModelProgram(model, device="cpu")
    assert p.device == torch.device("cpu")
    out, _ = p.run_fn(p.gather_endo(2), p.gather_exo(), host_params(p), p.gather_internals())
    assert np.isfinite(out["Surface Temperature"][1:].numpy()).all()


def test_calibration_runner_streams_with_the_full_loops_values(monkeypatch):
    """``CompiledModelRunner(stream=True)`` (the default) runs the streaming
    loop: bit-equal to ``stream=False`` and within 1e-9 of the JAX
    package's runner."""
    from rscm_tpu.calibrate import CompiledModelRunner as JaxRunner
    from rscm_tpu_torch.calibrate import CompiledModelRunner

    years = np.arange(1750.0, 1800.0)
    param_map = {"lambda0": "TwoLayer.lambda0", "tau": "CarbonCycle.tau"}
    out_vars = ["Surface Temperature", "Atmospheric Concentration|CO2"]
    thetas = np.array([[1.1, 30.0], [1.6, 45.0], [0.9, 20.0]])
    calls = []
    original = ModelProgram.run_window_fn

    def spy(self, *args, **kwargs):
        calls.append(1)
        return original(self, *args, **kwargs)

    monkeypatch.setattr(ModelProgram, "run_window_fn", spy)
    got = {}
    for stream in (True, False):
        calls.clear()
        runner = CompiledModelRunner(build_flagship("rscm_tpu_torch", years), param_map,
                                     out_vars, stream=stream, device="cpu")
        assert CompiledModelRunner(build_flagship("rscm_tpu_torch", years), param_map,
                                   out_vars, device="cpu").stream
        with torch.no_grad():
            got[stream] = runner.trajectories_fn()(thetas)
        assert len(calls) == int(stream)
    assert_bit_equal(got[True], got[False])
    jax_fn = JaxRunner(build_flagship("rscm_tpu", years), param_map, out_vars).trajectories_fn()
    for i, theta in enumerate(thetas):
        want = jax_fn(theta)
        for name in out_vars:
            np.testing.assert_allclose(got[True][name][i].numpy(), np.asarray(want[name]),
                                       rtol=1e-9, atol=1e-12, err_msg=name)
