"""The reference-API surface over the port (``rscm_tpu_torch.compat``)
against the one over the JAX package (``rscm``), imported side by side.

- Every test of ``tests/test_rscm_compat.py`` has a counterpart here, run
  on the port's surface on the CPU (``device="cpu"``, the port's rule for
  its entry points) and, where it computes, held against ``rscm``'s
  result: the two-layer builder model at 1e-12, the reference-idiom
  MAGICC assembly (50 layers, 1850-1930) at 1e-9, and every trajectory in
  float64.
- The names: every entry of ``REFERENCE_PUBLIC_API`` resolves, and every
  module's ``__all__`` equals ``rscm``'s.
- The windows: the same values and the same exceptions as ``rscm``'s on
  the same seeded numpy inputs, and from CPU tensors.
- ``install_as_rscm()`` in an interpreter where ``import jax`` fails.
- The ``_lib`` stubs are byte-identical to what the port's generator
  derives from the live modules.
"""

import ast
import difflib
import importlib
import pathlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import rscm
import rscm_tpu_torch.compat as compat
from rscm_tpu_torch.compat import generate_stubs
from test_rscm_compat import REFERENCE_PUBLIC_API

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = "rscm_tpu_torch.compat"
SURFACES = {"rscm": "rscm_tpu", PORT: "rscm_tpu_torch"}  # surface -> its engine
MAGICC_YEARS = np.arange(1850.0, 1931.0)


def port_name(name):
    """The port's counterpart of an ``rscm`` module path."""
    return PORT + name[len("rscm"):]


def surface(pkg, module):
    return importlib.import_module(f"{pkg}.{module}")


def run(model, pkg):
    model.run(**({"device": "cpu"} if pkg == PORT else {}))
    return model


def trajectories(model):
    return {item.name: np.asarray(item.data.values()) for item in model.collection}


def assert_trajectories_close(got, want, rtol, atol=0.0):
    assert set(got) == set(want)
    for name, values in got.items():
        assert values.dtype == np.float64, name
        np.testing.assert_allclose(values, want[name], rtol=rtol, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# tests/test_rscm_compat.py::TestCoreSurface
# ---------------------------------------------------------------------------


def test_reference_imports():
    from rscm_tpu_torch.compat.core import (  # noqa: F401
        FourBoxGrid, FourBoxRegion, FourBoxSlice, GridType,
        InterpolationStrategy, Model, ModelBuilder, PythonComponent,
        RequirementDefinition, RequirementType, TimeAxis, Timeseries,
        TimeseriesCollection, Unit, VariableSchema, VariableType,
    )
    import rscm_tpu_torch.core as engine

    assert ModelBuilder is engine.ModelBuilder and Model is engine.Model


@pytest.mark.parametrize("strategy", ["Linear", "Next", "Previous"])
def test_timeseries_reference_constructor(strategy):
    from rscm_tpu_torch.compat.core import InterpolationStrategy, TimeAxis, Timeseries

    ta = TimeAxis.from_values(np.arange(2000.0, 2010.0))
    ts = Timeseries(np.arange(10.0), ta, "GtC / yr", getattr(InterpolationStrategy, strategy))
    assert len(ts) == 10
    assert ts.values().shape == (10,)  # flat, like the reference
    assert ts.values().dtype == np.float64
    assert ts.latest_value() == 9.0
    ref = rscm.core.Timeseries(
        np.arange(10.0), rscm.core.TimeAxis.from_values(np.arange(2000.0, 2010.0)),
        "GtC / yr", getattr(rscm.core.InterpolationStrategy, strategy),
    )
    # every strategy extrapolates, as the reference's binding does
    for t in (2004.5, 1998.0, 2012.5):
        assert ts.at_time(t) == ref.at_time(t)
    if strategy == "Linear":
        assert ts.at_time(2004.5) == pytest.approx(4.5)


def test_unit():
    from rscm_tpu_torch.compat.core import Unit

    assert Unit("W/m^2") == Unit("W m^-2")
    assert Unit("GtC/yr").conversion_factor(Unit("MtCO2/yr")) == pytest.approx(
        1000 * 44 / 12
    )


def build_two_layer(pkg, years, lambda0=1.0):
    core, two_layer = surface(pkg, "core"), surface(pkg, "two_layer")
    component = two_layer.TwoLayerBuilder.from_parameters(
        {
            "lambda0": float(lambda0), "a": 0.0, "efficacy": 1.0, "eta": 0.7,
            "heat_capacity_surface": 8.0, "heat_capacity_deep": 100.0,
        }
    ).build()
    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_rust_component(component)
        .with_exogenous_variable(
            "Effective Radiative Forcing",
            core.Timeseries(np.full(len(years), 3.7), core.TimeAxis.from_values(years), "W/m^2"),
        )
        .with_initial_values({"Surface Temperature": 0.0, "Deep Ocean Temperature": 0.0})
        .build()
    )


def test_two_layer_via_builders():
    years = np.arange(2000.0, 2020.0)
    model = run(build_two_layer(PORT, years), PORT)
    assert model.finished()
    result = model.timeseries().get_timeseries_by_name("Surface Temperature")
    assert result.latest_value() > 0.5
    want = trajectories(run(build_two_layer("rscm", years), "rscm"))
    assert_trajectories_close(trajectories(model), want, rtol=1e-12)


def build_toml_model(pkg):
    core, examples = surface(pkg, "core"), surface(pkg, "example_components")
    years = np.arange(2020.0, 2025.0)
    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_rust_component(
            examples.TestComponentBuilder.from_parameters({"conversion_factor": 2.0}).build()
        )
        .with_exogenous_variable(
            "Emissions|CO2",
            core.Timeseries(np.arange(5.0), core.TimeAxis.from_values(years), "GtCO2"),
        )
        .build()
    )


def test_model_toml_roundtrip():
    from rscm_tpu_torch.compat.core import Model

    model = build_toml_model(PORT)
    model.step(device="cpu")
    restored = run(Model.from_toml(model.to_toml()), PORT)
    run(model, PORT)
    got = model.timeseries().get_timeseries_by_name("Concentrations|CO2").values()
    np.testing.assert_array_equal(
        got, restored.timeseries().get_timeseries_by_name("Concentrations|CO2").values()
    )
    ref = build_toml_model("rscm")
    ref.step()
    ref = rscm.core.Model.from_toml(ref.to_toml())
    ref.run()
    np.testing.assert_array_equal(
        got, ref.timeseries().get_timeseries_by_name("Concentrations|CO2").values()
    )


# ---------------------------------------------------------------------------
# TestTypedComponent: the reference's Scaler, and a component that reads
# its history through the reference windows (from tensors on the port)
# ---------------------------------------------------------------------------


def typed_model(pkg, kind, device=None):
    comp, core = surface(pkg, "component"), surface(pkg, "core")

    class Scaler(comp.Component, register=False):
        emissions = comp.Input("Emissions|CO2", unit="GtCO2")
        concentration = comp.Output("Concentrations|CO2", unit="ppm")

        def __init__(self, factor):
            super().__init__()
            self.factor = factor

        def solve(self, t_current, t_next, inputs):
            return self.Outputs(concentration=inputs.emissions.at_start() * self.factor)

    class Lagged(comp.Component, register=False):
        """The last three emissions' mean plus the previous one, read
        through a reference window over the history (on ``device``)."""

        emissions = comp.Input("Emissions|CO2", unit="GtCO2")
        concentration = comp.Output("Concentrations|CO2", unit="ppm")

        def solve(self, t_current, t_next, inputs):
            history = np.asarray(inputs.emissions.values)
            if device is not None:
                history = torch.as_tensor(history, device=device)
            window = core.TimeseriesWindow(history, int(inputs.emissions.current_index))
            previous = window.previous if int(window.current_index) > 0 else window.at_offset(0)
            return self.Outputs(concentration=previous + float(np.mean(window.last_n(3))))

    years = np.arange(2020.0, 2028.0)
    component = Scaler(3.0) if kind == "scaler" else Lagged()
    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_py_component(core.PythonComponent.build(component))
        .with_exogenous_variable(
            "Emissions|CO2",
            core.Timeseries(np.arange(1.0, 9.0) ** 1.5, core.TimeAxis.from_values(years), "GtCO2"),
        )
        .build()
    )


@pytest.mark.parametrize("kind", ["scaler", "lagged"])
def test_typed_python_component(kind):
    model = run(typed_model(PORT, kind, device="cpu"), PORT)
    conc = model.timeseries().get_timeseries_by_name("Concentrations|CO2")
    emissions = np.arange(1.0, 9.0) ** 1.5
    if kind == "scaler":
        assert conc.at(1) == pytest.approx(3.0)
    else:  # at step N: emissions[N - 1] + mean(emissions[N - 2 : N + 1])
        assert conc.at(3) == pytest.approx(emissions[1] + emissions[0:3].mean(), rel=1e-15)
    want = trajectories(run(typed_model("rscm", kind), "rscm"))
    got = trajectories(model)
    assert_trajectories_close(got, want, rtol=0.0)


# ---------------------------------------------------------------------------
# TestMagiccSurface, and the ten-component graph assembled from the builders
# ---------------------------------------------------------------------------


def test_builders_exist():
    import rscm_tpu_torch.compat.magicc as magicc

    for name in magicc.__all__:
        assert hasattr(magicc, name)


def test_climate_udeb_builder():
    from rscm_tpu_torch.compat.magicc import ClimateUDEBBuilder

    climate = ClimateUDEBBuilder.from_parameters({"ecs": 3.0, "forcing_2xco2": 3.71}).build()
    assert climate.ecs == 3.0


def assemble_magicc(pkg, years):
    """``build_magicc_model()``'s graph (its parameters, inputs and
    component order) assembled with the reference's idiom: each component
    from its builder, added with ``with_rust_component``."""
    core, magicc = surface(pkg, "core"), surface(pkg, "magicc")
    coupled = importlib.import_module(f"{SURFACES[pkg]}.magicc.coupled")
    init = coupled.INITIAL_VALUES
    emissions = coupled.idealised_emissions(years)
    pi = {gas: init[f"Atmospheric Concentration|{gas.upper()}"] for gas in ("co2", "ch4", "n2o")}
    builders = [
        magicc.CH4ChemistryBuilder.from_parameters({"ch4_pi": pi["ch4"]}),
        magicc.N2OChemistryBuilder.from_parameters({"n2o_pi": pi["n2o"]}),
        magicc.GhgForcingBuilder.from_parameters({
            "method": "Ipcctar", "co2_pi": pi["co2"], "ch4_pi": pi["ch4"], "n2o_pi": pi["n2o"],
            "adjust_co2": 1.0, "adjust_ch4": 1.0, "adjust_n2o": 1.0,
        }),
        magicc.OzoneForcingBuilder.from_parameters({}),
        magicc.AerosolDirectBuilder.from_parameters({}),
        magicc.AerosolIndirectBuilder.from_parameters({}),
        magicc.ClimateUDEBBuilder.from_parameters({"ecs": 3.0}),
        magicc.TerrestrialCarbonBuilder.from_parameters({}),
        magicc.OceanCarbonBuilder.from_parameters({"max_history_months": 12 * (len(years) + 1)}),
        magicc.CO2BudgetBuilder.from_parameters({}),
    ]
    axis = core.TimeAxis.from_values(years)
    builder = core.ModelBuilder().with_time_axis(axis).with_schema(
        coupled.build_magicc_schema(emissions)
    )
    for component in builders:
        builder = builder.with_rust_component(component.build())
    for name, (values, unit) in emissions.items():
        builder = builder.with_exogenous_variable(name, core.Timeseries(values, axis, unit))
    return builder.with_initial_values(dict(init)).build()


@pytest.fixture(scope="module")
def port_magicc():
    model = run(assemble_magicc(PORT, MAGICC_YEARS), PORT)
    udeb = next(c for c in model.graph.nodes if type(c).__name__ == "ClimateUDEB")
    assert udeb.n_layers == 50
    return trajectories(model)


def test_magicc_assembly_matches_rscm(port_magicc):
    want = trajectories(run(assemble_magicc("rscm", MAGICC_YEARS), "rscm"))
    assert_trajectories_close(port_magicc, want, rtol=1e-9, atol=1e-12)
    assert np.isfinite(port_magicc["Surface Temperature"][1:]).all()


def test_magicc_assembly_equals_build_magicc_model(port_magicc):
    from rscm_tpu_torch.magicc.coupled import build_magicc_model

    want = trajectories(run(build_magicc_model(years=MAGICC_YEARS), PORT))
    assert set(port_magicc) == set(want)
    for name, got in port_magicc.items():
        np.testing.assert_array_equal(got, want[name], err_msg=name)


# ---------------------------------------------------------------------------
# TestCalibrateSurface, TestConfigSurface
# ---------------------------------------------------------------------------


def point_estimate(pkg, optimizer):
    cal = surface(pkg, "calibrate")
    years = np.arange(2000.0, 2015.0)
    kwargs = {"device": "cpu"} if pkg == PORT else {}
    runner = cal.DefaultModelRunner(
        ["lambda0"], ["Surface Temperature"],
        lambda theta: build_two_layer(pkg, years, theta[0]), **kwargs,
    )
    truth = run(build_two_layer(pkg, years, 1.2), pkg)
    temps = truth.timeseries().get_timeseries_by_name("Surface Temperature")
    target = cal.Target()
    target.add_variable("Surface Temperature").add(2010.0, float(temps.at(10)), 0.05)
    params = cal.ParameterSet()
    params.add("lambda0", cal.Uniform(0.8, 1.8))
    estimator = cal.PointEstimator(params, runner, cal.GaussianLikelihood(), target)
    return estimator, estimator.optimize(optimizer(cal.Optimizer), 25)


def test_point_estimation_reference_style():
    _, result = point_estimate(PORT, lambda optimizer: optimizer.RandomSearch)
    assert isinstance(result, compat.calibrate.OptimizationResult)
    assert result.best_params[0] == pytest.approx(1.2, abs=0.25)
    assert result.n_evaluations == 25


def test_point_estimation_matches_rscm():
    got, got_result = point_estimate(PORT, lambda optimizer: optimizer.random_search(11))
    want, want_result = point_estimate("rscm", lambda optimizer: optimizer.random_search(11))
    np.testing.assert_array_equal(got.evaluated_params(), want.evaluated_params())
    np.testing.assert_allclose(got.evaluated_log_likelihoods(),
                               want.evaluated_log_likelihoods(), rtol=1e-12)
    assert got_result.best_params == want_result.best_params


def test_config_imports_and_magicc_legacy():
    from rscm_tpu_torch.compat.config import load_config_layers  # noqa: F401
    from rscm_tpu_torch.compat.config.models.magicc import from_legacy_dict

    config = from_legacy_dict({"core_climatesensitivity": 2.5})
    assert config["components"]["climate"]["parameters"]["climate_sensitivity"] == 2.5
    import rscm_tpu_torch.config.models.magicc.legacy as legacy
    from rscm_tpu_torch.compat.config.models.magicc import legacy as aliased

    assert aliased is legacy


# ---------------------------------------------------------------------------
# Names: REFERENCE_PUBLIC_API, and every module's __all__ equal to rscm's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("module_name", sorted(REFERENCE_PUBLIC_API))
def test_reference_public_api_present(module_name):
    module = importlib.import_module(port_name(module_name))
    missing = [name for name in REFERENCE_PUBLIC_API[module_name] if not hasattr(module, name)]
    assert not missing, f"{port_name(module_name)} missing reference names: {missing}"


#: the submodule aliases ``rscm.config`` and ``rscm.calibrate`` register
#: (``rscm/config/__init__.py:26-44``, ``rscm/calibrate/__init__.py:28``)
ALIASES = ["rscm.calibrate.progress"] + [f"rscm.config.{sub}" for sub in (
    "base", "builder", "docs", "exceptions", "loader", "models", "models.magicc",
    "models.magicc.legacy", "models.magicc.parameters", "models.two_layer", "parameters",
    "registry", "validation",
)]


def rscm_modules():
    """Every module path of ``rscm``: its files and its aliases."""
    files = {m.name for m in pkgutil.walk_packages(rscm.__path__, prefix="rscm.")}
    return sorted({"rscm"} | files | set(ALIASES))


@pytest.mark.parametrize("name", rscm_modules())
def test_every_rscm_module_has_a_counterpart(name):
    want = importlib.import_module(name)
    got = importlib.import_module(port_name(name))
    assert getattr(got, "__all__", None) == getattr(want, "__all__", None)
    for attr in getattr(want, "__all__", []):
        assert hasattr(got, attr), f"{port_name(name)}.{attr}"


def test_no_global_state():
    """``rscm`` flips JAX's x64 flag; the port's surface sets nothing:
    torch's default dtype stays, and the port's runs are float64 anyway
    (every test here checks its trajectories' dtype)."""
    code = (
        "import sys, torch\n"
        "sys.modules['jax'] = None\n"
        "before = torch.get_default_dtype()\n"
        "import rscm_tpu_torch.compat\n"
        "assert torch.get_default_dtype() is before is torch.float32\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# Windows: rscm/_windows.py's values and exceptions, from numpy and tensors
# ---------------------------------------------------------------------------

WINDOWS = {"TimeseriesWindow": 1, "FourBoxTimeseriesWindow": 4, "HemisphericTimeseriesWindow": 2}
N_ROWS = 7


def canonical(value):
    """A comparable form of what a window read returns."""
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        return ("float", value)
    if isinstance(value, np.ndarray):
        return ("array", str(value.dtype), value.tolist())
    if hasattr(value, "as_array"):
        return (type(value).__name__, [float(v) for v in value.as_array()])
    if isinstance(value, (list, tuple)):
        return [canonical(v) for v in value]
    if isinstance(value, np.floating):
        return ("numpy float", float(value))
    return (type(value).__name__, value)


def outcome(fn):
    try:
        return canonical(fn())
    except (ValueError, AssertionError, IndexError) as exc:
        return ("raises", type(exc).__name__, str(exc))


def window_reads(window, n_regions):
    reads = {
        "previous": lambda: window.previous,
        "len": lambda: len(window),
        "repr": lambda: repr(window),
        "index": lambda: int(window.index()),
    }
    if n_regions == 1:
        for offset in (-N_ROWS, -2, -1, 0, 1, N_ROWS):
            reads[f"at_offset({offset})"] = lambda o=offset: window.at_offset(o)
        for n in (1, 3, N_ROWS + 2):
            reads[f"last_n({n})"] = lambda n=n: window.last_n(n)
        reads["to_array"] = window.to_array
        reads["at_start"] = window.at_start
        reads["at_end"] = window.at_end
        reads["get"] = window.get
    else:
        for region in (-1, 0, n_regions - 1, n_regions):
            reads[f"at_start({region})"] = lambda r=region: window.at_start(r)
            reads[f"at_end({region})"] = lambda r=region: window.at_end(r)
            reads[f"region({region})"] = lambda r=region: window.region(r).to_array()
            reads[f"region({region}).previous"] = lambda r=region: window.region(r).previous
        reads["at_start_all"] = window.at_start_all
        reads["at_end_all"] = window.at_end_all
    return {name: outcome(read) for name, read in reads.items()}


@pytest.mark.parametrize("source", ["numpy", "tensor"])
@pytest.mark.parametrize("cls_name", sorted(WINDOWS))
def test_windows_match_rscm(cls_name, source):
    n_regions = WINDOWS[cls_name]
    rng = np.random.default_rng(17 + n_regions)
    values = rng.normal(size=(N_ROWS, n_regions))
    if n_regions == 1 and source == "numpy":
        values = values[:, 0]  # the 1-D form the scalar window also takes
    given = torch.from_numpy(values) if source == "tensor" else values
    ref_cls = getattr(rscm.core, cls_name)
    port_cls = getattr(compat.core, cls_name)
    for index in (0, 1, N_ROWS // 2, N_ROWS - 1):
        want = window_reads(ref_cls(values, index, 2000.0 + index), n_regions)
        got = window_reads(port_cls(given, index, 2000.0 + index), n_regions)
        assert got == want, (cls_name, index)
    bad_columns = np.zeros((N_ROWS, n_regions + 1))
    for args in ((values, -1), (values, N_ROWS), (bad_columns, 0)):
        port_args = (torch.from_numpy(np.asarray(args[0])),) if source == "tensor" else args[:1]
        want = outcome(lambda: ref_cls(*args))
        got = outcome(lambda: port_cls(*port_args, args[1]))
        assert got[0] == want[0] == "raises" and got == want


# ---------------------------------------------------------------------------
# install_as_rscm()
# ---------------------------------------------------------------------------

INSTALL = """
import sys
sys.modules['jax'] = None
import numpy as np
from rscm_tpu_torch.compat import install_as_rscm
install_as_rscm()
install_as_rscm()
import rscm
import rscm.core
import rscm._lib.core.state
import rscm.calibrate.progress
import rscm.config.models.magicc.legacy
from rscm.core import ModelBuilder, TimeAxis, Timeseries
from rscm.two_layer import TwoLayerBuilder
import rscm_tpu_torch.core
import rscm_tpu_torch.config.models.magicc.legacy as legacy
assert rscm.core.ModelBuilder is rscm_tpu_torch.core.ModelBuilder
assert rscm._lib.core.state.TimeseriesWindow is rscm.core.TimeseriesWindow
assert rscm.config.models.magicc.legacy is legacy
assert rscm.core.__spec__.name == 'rscm_tpu_torch.compat.core'
years = np.arange(2000.0, 2020.0)
model = (
    ModelBuilder()
    .with_time_axis(TimeAxis.from_values(years))
    .with_rust_component(TwoLayerBuilder.from_parameters({
        'lambda0': 1.0, 'a': 0.0, 'efficacy': 1.0, 'eta': 0.7,
        'heat_capacity_surface': 8.0, 'heat_capacity_deep': 100.0}).build())
    .with_exogenous_variable('Effective Radiative Forcing',
                             Timeseries(np.full(20, 3.7), TimeAxis.from_values(years), 'W/m^2'))
    .with_initial_values({'Surface Temperature': 0.0, 'Deep Ocean Temperature': 0.0})
    .build()
)
model.run(device='cpu')
temps = model.timeseries().get_timeseries_by_name('Surface Temperature')
assert temps.values().dtype == np.float64 and temps.latest_value() > 0.5
try:
    import rscm.nothing_of_the_reference
except ModuleNotFoundError:
    pass
else:
    raise AssertionError('an unknown rscm path imported')
assert not any(m == 'rscm_tpu' or m.startswith('rscm_tpu.') for m in sys.modules)
print('ok')
"""

FOREIGN = """
import sys, types
sys.modules['jax'] = None
sys.modules['rscm'] = types.ModuleType('rscm')
from rscm_tpu_torch.compat import install_as_rscm
try:
    install_as_rscm()
except ImportError as exc:
    assert 'different' in str(exc), exc
else:
    raise AssertionError('install_as_rscm() took over a foreign rscm')
assert not any(type(f).__name__ == '_RscmFinder' for f in sys.meta_path)
print('ok')
"""


@pytest.mark.parametrize("script", [INSTALL, FOREIGN], ids=["install", "foreign_rscm_raises"])
def test_install_as_rscm(script):
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_install_as_rscm_refuses_the_jax_surface():
    """Here ``rscm`` (the JAX package's surface) is imported already."""
    assert rscm.__name__ == "rscm" and "rscm" in sys.modules
    with pytest.raises(ImportError, match="different"):
        compat.install_as_rscm()
    assert sys.modules["rscm"] is rscm


# ---------------------------------------------------------------------------
# Stubs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod_name,stub_path", sorted(generate_stubs.MODULES.items()))
def test_stub_signatures_match_live_surface(mod_name, stub_path):
    """Each .pyi on disk is exactly what the generator derives from the
    live module (re-run ``python -m rscm_tpu_torch.compat.generate_stubs``)."""
    expected = generate_stubs.stub_module(importlib.import_module(mod_name))
    actual = (ROOT / stub_path).read_text()
    diff = "\n".join(difflib.unified_diff(
        actual.splitlines(), expected.splitlines(), fromfile=f"{stub_path} (on disk)",
        tofile=f"{stub_path} (from live surface)", lineterm="", n=2,
    ))
    assert actual == expected, f"stub drift in {stub_path}:\n{diff}"


def stub_names(path):
    tree = ast.parse(path.read_text())
    return {node.name for node in tree.body if isinstance(node, (ast.ClassDef, ast.FunctionDef))} | {
        node.target.id for node in tree.body
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name)
    }


def test_stubs_are_the_counterparts_of_rscm_stubs():
    """The generator covers every stub the port ships, one for each of
    ``rscm/_lib``'s, with the same top-level names."""
    port_lib = ROOT / "rscm_tpu_torch" / "compat" / "_lib"
    shipped = {str(p.relative_to(ROOT)) for p in port_lib.rglob("*.pyi")}
    assert shipped == set(generate_stubs.MODULES.values())
    reference = {p.relative_to(ROOT / "rscm" / "_lib") for p in (ROOT / "rscm" / "_lib").rglob("*.pyi")}
    assert {p.relative_to(port_lib) for p in port_lib.rglob("*.pyi")} == reference
    for rel in reference:
        assert stub_names(port_lib / rel) == stub_names(ROOT / "rscm" / "_lib" / rel), rel
