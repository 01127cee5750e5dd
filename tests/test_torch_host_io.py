"""The port's host input and diagnostics against the reference's.

Mirrors ``tests/test_scenario_io.py``, ``tests/test_native_graph.py`` and
``tests/test_profiling.py``:

- the native CSV loader and graph engine (built with ``g++`` into
  ``rscm_tpu_torch/_build/``) against their pure-Python fallbacks and the
  reference's readers, on the same files and graphs: equal results;
- scenario CSVs and config-driven inputs: equal series, and models whose
  runs match the reference's at 1e-9;
- ``diagnose_nans`` finds what the reference finds; ``cost_analysis``
  keeps the reference's keys and counts each hand kernel's work from the
  formulas of its roofline bound; ``trace_profile`` writes a trace.
"""

import random

import numpy as np
import pytest
import torch

from test_torch_support import build_udeb, step_erf, values


def write(tmp_path, text, name="data.csv"):
    path = tmp_path / name
    path.write_text(text)
    return path


@pytest.fixture
def csv_mod():
    from rscm_tpu_torch.native import csv

    assert csv.native_loader(), "native CSV library failed to build"
    return csv


# -- the CSV loader ------------------------------------------------------------------


def test_native_csv_builds_into_the_package(csv_mod):
    from rscm_tpu_torch.native import _BUILD_DIR, build_library

    path = build_library("csv_loader.cpp")
    assert path is not None and path.parent == _BUILD_DIR and path.exists()


def test_parse_basic_matches_reference(tmp_path, csv_mod):
    from rscm_tpu.native.csv import read_numeric_csv as reference

    path = write(tmp_path, "time,A,B\n2000,1.5,2.5\n2001,3.0,4.0\n")
    header, vals = csv_mod.read_numeric_csv(path)
    assert header == ["time", "A", "B"]
    np.testing.assert_array_equal(vals, [[2000.0, 1.5, 2.5], [2001.0, 3.0, 4.0]])
    ref_header, ref_vals = reference(path)
    assert header == ref_header
    np.testing.assert_array_equal(vals, ref_vals)


def test_native_matches_python_on_random_tables(tmp_path, csv_mod):
    from rscm_tpu.native.csv import read_numeric_csv as reference

    rng = np.random.default_rng(0)
    for trial in range(10):
        rows, cols = rng.integers(2, 50), rng.integers(2, 8)
        table = rng.standard_normal((rows, cols)) * 10.0 ** rng.integers(-8, 8)
        header = ",".join(["time"] + [f"V{j}" for j in range(cols - 1)])
        body = "\n".join(",".join(repr(float(v)) for v in row) for row in table)
        path = write(tmp_path, f"{header}\n{body}\n", name=f"t{trial}.csv")
        h_native, v_native = csv_mod.read_numeric_csv(path)
        h_py, v_py = csv_mod._read_python(path)
        h_ref, v_ref = reference(path)
        assert h_native == h_py == h_ref
        np.testing.assert_array_equal(v_native, v_py)
        np.testing.assert_array_equal(v_native, v_ref)


@pytest.mark.parametrize(
    "text",
    ["time,A\n1,2\n3\n", "time,A\n1,\n", "time,A\n1,abc\n", "time,A\n1,1 2\n",
     "time,A\n1 0,2\n"],
    ids=["ragged", "empty_cell", "non_numeric", "interior_space", "interior_space_first"],
)
def test_malformed_rejected_by_both_parsers(tmp_path, csv_mod, text):
    path = write(tmp_path, text)
    for reader in (csv_mod.read_numeric_csv, csv_mod._read_python):
        with pytest.raises(ValueError, match="malformed numeric CSV"):
            reader(path)


def test_whitespace_and_trailing_newline(tmp_path, csv_mod):
    path = write(tmp_path, "time,A\n 1 , 2.5\n3,\t4 ")
    assert csv_mod.read_numeric_csv(path)[0] == csv_mod._read_python(path)[0]
    np.testing.assert_array_equal(csv_mod.read_numeric_csv(path)[1], [[1.0, 2.5], [3.0, 4.0]])
    np.testing.assert_array_equal(csv_mod._read_python(path)[1], [[1.0, 2.5], [3.0, 4.0]])


def test_switch_forces_the_python_fallback(tmp_path):
    """``RSCM_TPU_NATIVE=0`` in a fresh interpreter: no library is loaded
    and the CSV reads through Python."""
    import subprocess
    import sys
    from pathlib import Path

    path = write(tmp_path, "time,A\n1,2\n3,4\n")
    code = (
        "from rscm_tpu_torch.native import load_graph_engine\n"
        "from rscm_tpu_torch.native.csv import native_loader, read_numeric_csv\n"
        "assert load_graph_engine() is None and not native_loader()\n"
        f"print(read_numeric_csv({str(path)!r})[1].tolist())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parent.parent,
                         env={**__import__("os").environ, "RSCM_TPU_NATIVE": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[[1.0, 2.0], [3.0, 4.0]]"


# -- scenario files -----------------------------------------------------------------


def test_load_scenario_matches_reference(tmp_path):
    from rscm_tpu.utils.scenario_io import load_scenario_csv as reference
    from rscm_tpu_torch.utils.scenario_io import load_scenario_csv

    path = write(tmp_path, "time,Emissions|CO2,Effective Radiative Forcing\n"
                           "2000,1.0,0.5\n2001,2.0,0.6\n2002,3.0,0.7\n")
    series = load_scenario_csv(path, units={"Emissions|CO2": "GtC/yr"})
    ref = reference(path, units={"Emissions|CO2": "GtC/yr"})
    assert sorted(series) == sorted(ref) == ["Effective Radiative Forcing", "Emissions|CO2"]
    for name, ts in series.items():
        assert ts.units == ref[name].units
        np.testing.assert_array_equal(ts.values(), ref[name].values())
        np.testing.assert_array_equal(ts.time_axis().values(), ref[name].time_axis().values())
    assert series["Emissions|CO2"].units == "GtC/yr"


@pytest.mark.parametrize(
    "text, message",
    [("time,A\n2001,1\n2000,2\n", "strictly increasing"),
     ("A,B\n1,2\n3,4\n", "first column must be the time axis"),
     ("time\n1\n2\n", "need a time column"),
     ("time,A\n1,2\n", "at least two time points")],
    ids=["non_monotonic", "wrong_first_column", "no_variable", "one_row"],
)
def test_scenario_rejections(tmp_path, text, message):
    from rscm_tpu.utils.scenario_io import load_scenario_csv as reference
    from rscm_tpu_torch.utils.scenario_io import load_scenario_csv

    path = write(tmp_path, text)
    for load in (load_scenario_csv, reference):
        with pytest.raises(ValueError, match=message):
            load(path)


def test_load_input_spec_matches_reference(tmp_path):
    from rscm_tpu.utils.scenario_io import load_input_spec as reference
    from rscm_tpu_torch.utils.scenario_io import load_input_spec

    write(tmp_path, "year,Other\n2000,1\n2001,2\n", name="one.csv")
    write(tmp_path, "time,X,Y\n2000,1,5\n2001,2,6\n", name="two.csv")
    spec = {"file": "one.csv", "unit": "W/m^2"}
    with pytest.warns(UserWarning, match="only data column"):
        ts = load_input_spec("Effective Radiative Forcing", spec, base_dir=tmp_path)
    with pytest.warns(UserWarning):
        want = reference("Effective Radiative Forcing", spec, base_dir=tmp_path)
    np.testing.assert_array_equal(ts.values(), want.values())
    assert ts.units == want.units == "W/m^2"
    np.testing.assert_array_equal(
        load_input_spec("Y", {"file": "two.csv"}, base_dir=tmp_path).values()[:, 0], [5.0, 6.0])
    with pytest.raises(KeyError, match="column not found"):
        load_input_spec("Z", {"file": "two.csv"}, base_dir=tmp_path)
    with pytest.raises(ValueError, match="no file given"):
        load_input_spec("Z", {"unit": "1"})


def test_config_with_file_input_matches_reference(tmp_path):
    years = np.arange(2000.0, 2081.0)
    write(tmp_path, "time,Effective Radiative Forcing\n"
          + "".join(f"{t},{v}\n" for t, v in zip(years, np.linspace(0.0, 4.0, len(years)))),
          name="erf.csv")
    config_path = write(
        tmp_path,
        '[model]\nname = "t"\ntype = "two-layer"\n[time]\nstart = 2000\nend = 2080\n'
        '[components.climate]\ntype = "TwoLayer"\n[components.climate.parameters]\n'
        "lambda0 = 1.0\na = 0.0\nefficacy = 1.0\neta = 0.7\n"
        "heat_capacity_surface = 8.0\nheat_capacity_deep = 100.0\n"
        '[inputs]\n"Effective Radiative Forcing" = { file = "erf.csv", unit = "W/m^2" }\n',
        name="model.toml",
    )
    from rscm_tpu.config import build_model as reference_build, load_config as reference_load
    from rscm_tpu_torch.config import build_model, load_config

    model = build_model(load_config(config_path))
    model.run(device="cpu")
    ref = reference_build(reference_load(config_path))
    ref.run()
    temp = values(model, "Surface Temperature")[:, 0]
    assert np.isfinite(temp[-1]) and temp[-1] > 1.0
    np.testing.assert_allclose(temp, values(ref, "Surface Temperature")[:, 0], rtol=1e-9,
                               atol=1e-9)


# -- the graph engine -------------------------------------------------------------------


class Named:
    def __init__(self, name):
        self.component_name = name


def python_graph(n_nodes, edges):
    """A ComponentGraph forced onto the pure-Python traversals."""
    from rscm_tpu_torch.core.model.graph import ComponentGraph

    g = ComponentGraph()
    for i in range(n_nodes):
        g.add_node(Named(f"C{i}"))
    for src, dst in edges:
        g.add_edge(src, dst, None)
    g._native_engine = lambda: None
    return g


def random_dag(rng, n_nodes, extra_edges):
    edges = [(rng.randrange(dst), dst) for dst in range(1, n_nodes)]
    for _ in range(extra_edges):
        a, b = rng.randrange(n_nodes), rng.randrange(n_nodes)
        if a != b:
            edges.append((min(a, b), max(a, b)))
    rng.shuffle(edges)
    return edges


@pytest.fixture
def engine():
    from rscm_tpu_torch.native import load_graph_engine

    engine = load_graph_engine()
    assert engine is not None, "native graph engine failed to build"
    return engine


@pytest.mark.parametrize("order", ["bfs", "topo"])
def test_engine_matches_python_and_reference_on_random_dags(engine, order):
    from rscm_tpu.core.model.graph import ComponentGraph as ReferenceGraph

    rng = random.Random(order == "topo")
    for trial in range(50):
        n = rng.randrange(2, 30)
        edges = random_dag(rng, n, rng.randrange(0, 2 * n))
        py = python_graph(n, edges)
        ref = ReferenceGraph()
        for i in range(n):
            ref.add_node(Named(f"C{i}"))
        for src, dst in edges:
            ref.add_edge(src, dst, None)
        ref._native_engine = lambda: None
        if order == "bfs":
            got, want, oracle = engine.bfs_order(n, edges, 0), py.bfs_order(0), ref.bfs_order(0)
        else:
            got, want, oracle = engine.topo_order(n, edges), py.topo_order(0), ref.topo_order(0)
        assert got == want == oracle, f"trial {trial}: n={n} edges={edges}"


def test_engine_multi_edges_self_loops_and_neighbor_order(engine):
    edges = [(0, 1), (0, 1), (1, 1), (1, 2), (0, 2), (2, 2)]
    assert engine.topo_order(3, edges) == python_graph(3, edges).topo_order(0) == [0, 1, 2]
    assert engine.bfs_order(3, [(0, 1), (0, 2)], 0) == [0, 2, 1]


def test_cycle_detection_matches_python(engine):
    from rscm_tpu_torch.core.errors import CircularDependencyError

    edges = [(0, 1), (1, 2), (2, 1)]
    offender = engine.find_cycle(3, edges)
    with pytest.raises(CircularDependencyError) as exc:
        python_graph(3, edges).check_acyclic()
    assert f"'C{offender}'" in str(exc.value)
    assert engine.find_cycle(2, [(0, 0), (0, 1), (1, 1)]) == -1
    python_graph(2, [(0, 0), (0, 1), (1, 1)]).check_acyclic()


@pytest.mark.parametrize("bad", [(0, 5), (5, 0), (-1, 0), (0, -1)])
def test_out_of_range_edges_raise(engine, bad):
    edges = [(0, 1), bad]
    for call in (lambda: engine.bfs_order(2, edges, 0), lambda: engine.topo_order(2, edges),
                 lambda: engine.find_cycle(2, edges)):
        with pytest.raises(ValueError, match="out of range"):
            call()


def test_model_order_is_the_same_with_and_without_the_engine(engine, monkeypatch):
    """The MAGICC graph and the flagship graph execute in the same order with
    the engine, without it, and in the reference."""
    from rscm_tpu.magicc.coupled import build_magicc_model as reference_magicc
    from rscm_tpu_torch.core.model.graph import ComponentGraph
    from rscm_tpu_torch.magicc.coupled import build_magicc_model
    from test_torch_support import build_flagship

    years = np.arange(1850.0, 1855.0)
    builders = [
        (lambda: build_magicc_model(years=years, include_permafrost=True, include_slr=True),
         lambda: reference_magicc(years=years, include_permafrost=True, include_slr=True)),
        (lambda: build_flagship("rscm_tpu_torch", years),
         lambda: build_flagship("rscm_tpu", years)),
    ]
    native = [build().exec_order for build, _ in builders]
    monkeypatch.setattr(ComponentGraph, "_native_engine", staticmethod(lambda: None))
    python = [build().exec_order for build, _ in builders]
    assert native == python == [ref().exec_order for _, ref in builders]


# -- diagnostics -------------------------------------------------------------------------


def poisoned_model(pkg):
    import importlib

    core = importlib.import_module(f"{pkg}.core")

    class Poison(core.Component, register=False):
        x = core.Input("X", unit="1")
        y = core.Output("Y", unit="1")

        def solve_ctx(self, ctx, inputs, st):
            v = inputs.x.get()
            return self.Outputs(y=v if ctx.t_current < 2002.0 else float("nan")), st

    class Downstream(core.Component, register=False):
        y = core.Input("Y", unit="1")
        z = core.Output("Z", unit="1")

        def solve_ctx(self, ctx, inputs, st):
            return self.Outputs(z=inputs.y.get() * 2.0), st

    years = np.arange(2000.0, 2006.0)
    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_component(Poison())
        .with_component(Downstream())
        .with_exogenous_variable("X", core.Timeseries.from_values(np.ones(6), years))
        .build()
    )


def test_diagnose_nans_finds_first_offender():
    from rscm_tpu.utils.profiling import diagnose_nans as reference
    from rscm_tpu_torch.utils.profiling import diagnose_nans

    found = diagnose_nans(poisoned_model("rscm_tpu_torch"), device="cpu")
    assert found == reference(poisoned_model("rscm_tpu"))
    assert found[0] == {"step": 2, "time": 2002.0, "component": "Poison", "variable": "Y"}
    assert any(f["component"] == "Downstream" for f in found)
    assert diagnose_nans(poisoned_model("rscm_tpu_torch"), max_steps=2, device="cpu") == []


def test_diagnose_nans_names_the_nan_input_year_reader_and_output():
    """A NaN put into one exogenous input of the MAGICC graph at a known year:
    the first finding names that year, the first component that reads the
    input and the variable it writes, as the reference's does."""
    from rscm_tpu.magicc.coupled import build_magicc_model as reference_magicc
    from rscm_tpu.utils.profiling import diagnose_nans as reference
    from rscm_tpu_torch.magicc.coupled import build_magicc_model
    from rscm_tpu_torch.utils.profiling import diagnose_nans

    years = np.arange(1850.0, 1862.0)
    found = []
    for build, diagnose, kw in ((build_magicc_model, diagnose_nans, {"device": "cpu"}),
                                (reference_magicc, reference, {})):
        model = build(years=years)
        data = model.collection.get_data("Emissions|CH4")
        data._values[6] = np.nan
        data._recompute_latest()
        found.append(diagnose(model, **kw))
    assert found[0] == found[1]
    assert found[0][0]["time"] == 1856.0
    assert found[0][0]["component"] == "CH4Chemistry"
    assert found[0][0]["variable"] == "Lifetime|CH4"  # the first of its outputs


def test_diagnostics_need_a_card_unless_told():
    from rscm_tpu_torch.utils.profiling import cost_analysis, diagnose_nans

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for diagnose in (diagnose_nans, cost_analysis):
        model = poisoned_model("rscm_tpu_torch")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            diagnose(model)
        assert model.time_index == 0


def test_cost_analysis_keeps_the_reference_keys():
    from rscm_tpu.utils.profiling import cost_analysis as reference
    from rscm_tpu_torch.utils.profiling import cost_analysis

    years = np.arange(1850.0, 1856.0)
    model = build_udeb("rscm_tpu_torch", years, step_erf(years))
    costs = cost_analysis(model, device="cpu")
    want = reference(build_udeb("rscm_tpu", years, step_erf(years), month_engine="xla"))
    assert {"flops", "bytes accessed"} <= set(costs) & set(want)
    assert costs["flops"] > 0 and costs["bytes accessed"] > 0 and costs["operators"] > 0
    assert costs["kernel launches"] == {}  # the CPU runs the plain versions
    assert model.time_index == 0  # the model is not advanced


def test_runner_cost_analysis_and_base_args():
    from rscm_tpu.parallel import EnsembleRunner as ReferenceRunner
    from rscm_tpu_torch.parallel import EnsembleRunner

    years = np.arange(1850.0, 1856.0)
    runner = EnsembleRunner(build_udeb("rscm_tpu_torch", years, step_erf(years)), device="cpu")
    params = runner.batched_params({"ClimateUDEB.ecs": np.array([2.0, 3.0, 4.0])})
    one = runner.cost_analysis(runner.batched_params({"ClimateUDEB.ecs": np.array([3.0])}),
                               out_vars=["Surface Temperature"])
    three = runner.cost_analysis(params, out_vars=["Surface Temperature"])
    assert three["flops"] > one["flops"] > 0
    ref = ReferenceRunner(build_udeb("rscm_tpu", years, step_erf(years), month_engine="xla"))
    got, want = runner.base_args(), ref.base_args()
    assert len(got) == len(want) == 4
    endo, exo, params, internals = got
    assert set(endo) == set(want[0]) and set(exo) == set(want[1])
    for name, rows in endo.items():
        np.testing.assert_array_equal(rows[:, 0].numpy(), np.asarray(want[0][name]))
    assert set(params) == set(want[2]) and set(internals) == set(want[3])


def test_kernel_launches_are_counted_from_the_bound_formulas():
    """A launch reported inside ``count_costs`` adds the kernel's work from
    its wrapper's formula and nothing of the plain version the formula runs;
    the formula's operations equal the plain version's arithmetic."""
    from rscm_tpu_torch.ops import lamcalc_kernel, udeb_month
    from rscm_tpu_torch.ops.work import count_arithmetic, note_launch
    from rscm_tpu_torch.utils.profiling import count_costs

    b, n = 300, 5
    rng = np.random.default_rng(0)
    st = udeb_month.UdebStatic(
        n=n, steps=12, dt_sub=1.0 / 12, dz=100.0, dz_mix=60.0, c_mix=0.5,
        af_top=(1.0,) * n, af_bot=(1.0,) * n, af_diff=(0.0,) * n,
        relative_depth=tuple(np.linspace(0.0, 1.0, n - 1)),
        inv_dz_dzup=(1e-4,) * (n - 2), f_l=(0.2, 0.1), fg=(0.3, 0.2, 0.4, 0.1),
        qfrac=(1.0, 1.0, 1.0, 1.0), diffusivity_scale=1.0, land_heat_enabled=True,
    )
    scal = torch.tensor(rng.uniform(0.5, 1.5, (udeb_month.S + 2, b)))
    ocean = torch.tensor(rng.uniform(0.0, 1.0, (2 * n, b)))
    init = torch.tensor(rng.uniform(0.0, 1.0, (2 * n, 1))).expand(2 * n, b)
    vec = torch.tensor(rng.uniform(0.0, 1.0, (10, b)))
    other, divisions, nbytes = udeb_month.udeb_year_work(st, scal, ocean, init, vec)
    full = count_arithmetic(udeb_month.udeb_year_plain, st, scal, ocean, init, vec)
    # scaled from the first 256 members: 24 operations a launch do not grow
    # with the batch (per-hemisphere constants), a few parts in a million
    assert (other, divisions) == pytest.approx(full, rel=1e-5)
    assert nbytes == 8 * (scal.numel() + 2 * ocean.numel() + 2 * n + vec.numel() + 8 * b)
    with count_costs() as costs:
        note_launch("udeb_year", udeb_month.udeb_year_work, st, scal, ocean, init, vec)
        note_launch("udeb_year", udeb_month.udeb_year_work, st, scal, ocean, init, vec)
    assert costs["kernel launches"] == {"udeb_year": 2}
    assert costs["flops"] == pytest.approx(2 * (other + divisions))
    assert costs["bytes accessed"] == 2 * nbytes and costs["operators"] == 0
    _ = lamcalc_kernel.lamcalc_work  # the other kernel states its work the same way


def test_trace_profile_writes_a_trace(tmp_path):
    from rscm_tpu_torch.utils.profiling import trace_profile

    years = np.arange(1850.0, 1853.0)
    model = build_udeb("rscm_tpu_torch", years, step_erf(years))
    with trace_profile(str(tmp_path)):
        model.run(device="cpu")
    assert list(tmp_path.rglob("*.json")) or list(tmp_path.rglob("*.pt.trace.json*"))
