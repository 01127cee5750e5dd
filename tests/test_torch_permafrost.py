"""Permafrost (module_12, beyond the reference) through the port, and the
full-options MAGICC graph (permafrost and sea-level rise) against
``rscm_tpu``.

- Every case of ``tests/test_permafrost.py`` runs through the port's
  component, on host floats (numpy) and on one-member tensors (torch).
- ``Permafrost.solve_permafrost`` over a batch of members whose swept
  parameters and temperatures differ agrees with the JAX component run
  member by member within 1e-12, states and outputs, with the moisture
  sensitivity on (the monthly anaerobic fraction) and off.
- ``build_magicc_model(include_permafrost=True, include_slr=True)`` at one
  member (every variable, 1e-9) and 16 members (``EnsembleRunner.run``,
  1e-8) against the JAX package, the conservation identity of the
  permafrost pools per member within ``CONSERVATION_GTC``, and the
  port's step-by-step executor against its year loop.
"""

import importlib

import numpy as np
import pytest
import torch

from rscm_tpu.magicc import Permafrost as JaxPermafrost
from rscm_tpu.magicc.coupled import build_magicc_model as jax_build
from rscm_tpu.parallel import EnsembleRunner as JaxEnsembleRunner
from rscm_tpu_torch.convert import apply_static_params, params_from_jax, static_params_from_jax
from rscm_tpu_torch.magicc import Permafrost
from rscm_tpu_torch.magicc.carbon.permafrost import MT_CH4_PER_GTC
from rscm_tpu_torch.magicc.coupled import build_magicc_model, idealised_emissions
from rscm_tpu_torch.parallel import EnsembleRunner

#: |total pool + cumulative emissions - initial pool| per member, GtC, from
#: the run's outputs over 1850-1910 in float64 (chip_smoke.py holds the
#: card's 251-year run to the same bound)
CONSERVATION_GTC = 1e-8


def numpy_of(x):
    """A value of the host or the one-member tensor mode as numpy (the
    member axis of a one-member tensor dropped)."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
        return x[0] if x.ndim >= 1 else x
    return np.asarray(x)


@pytest.fixture(params=["host", "tensor"])
def solve(request):
    """``solve(pf, state, temperature, dt)`` on host floats, or on a
    one-member tensor temperature; returns numpy state and outputs."""
    tensor = request.param == "tensor"

    def run(pf, state, t, dt=1.0):
        temp = torch.tensor([float(t)], dtype=torch.float64) if tensor else float(t)
        if tensor:
            state = {k: torch.as_tensor(np.asarray(v, dtype=np.float64)) for k, v in state.items()}
            state = {k: v[None] if v.dim() else v for k, v in state.items()}
        st, out = pf.solve_permafrost(state, temp, dt)
        return ({k: numpy_of(v) for k, v in st.items()},
                {k: float(numpy_of(v)) for k, v in out.items()})

    return run


def run_years(solve, pf, temps, dt=1.0):
    st = pf.create_initial_state()
    out = None
    for t in np.atleast_1d(temps):
        st, out = solve(pf, st, t, dt)
    return st, out


# -- tests/test_permafrost.py's spec cases ----------------------------------

class TestSpecCases:
    def test_no_warming_is_inert(self, solve):
        st, out = run_years(solve, Permafrost(), np.zeros(20))
        assert out["co2"] == pytest.approx(0.0, abs=1e-12)
        assert out["ch4_mt"] == pytest.approx(0.0, abs=1e-12)
        assert out["total_pool"] == pytest.approx(800.0, abs=1e-9)
        assert out["thawed_fraction"] == pytest.approx(0.0, abs=1e-12)
        np.testing.assert_allclose(st["ms_frozen_area"], 1.0)

    def test_single_band_thaw_rate(self, solve):
        st, out = run_years(solve, Permafrost(n_bands=1), np.ones(10))
        assert st["ms_frozen_area"][0] == pytest.approx(0.93**10, abs=1e-12)
        assert st["peat_frozen_area"][0] == pytest.approx(0.965**10, abs=1e-12)
        assert out["co2"] > 0.0
        assert out["ch4_mt"] > 0.0

    def test_conservation_identity(self, solve):
        pf = Permafrost()
        st = pf.create_initial_state()
        for k in range(100):
            st, out = solve(pf, st, 0.03 * k)
        assert out["total_pool"] + float(st["cumulative_emissions"]) == pytest.approx(
            800.0, abs=1e-8)
        assert st["cumulative_emissions"] > 1.0

    def test_ch4_co2_partitioning(self, solve):
        ms_only = Permafrost(minsoil_southern_fraction=1.0, minsoil_northern_fraction=1.0)
        peat_only = Permafrost(minsoil_southern_fraction=0.0, minsoil_northern_fraction=0.0)
        _, out_ms = run_years(solve, ms_only, np.full(30, 2.0))
        _, out_peat = run_years(solve, peat_only, np.full(30, 2.0))
        assert out_peat["ch4_mt"] / out_peat["co2"] > 3.0 * out_ms["ch4_mt"] / out_ms["co2"]

    def test_complete_thaw_is_stable(self, solve):
        pf = Permafrost(n_bands=10)
        st, out = run_years(solve, pf, np.full(400, 10.0))
        assert np.all(np.isfinite(st["ms_frozen_area"]))
        assert out["thawed_fraction"] == pytest.approx(1.0, abs=1e-6)
        assert st["cumulative_emissions"] > 0.9 * 800.0
        assert out["total_pool"] + float(st["cumulative_emissions"]) == pytest.approx(
            800.0, abs=1e-7)

    def test_refreeze(self, solve):
        pf = Permafrost(n_bands=4)
        st, out = run_years(solve, pf, np.full(20, 3.0))
        hot = out["thawed_fraction"]
        frozen_pool_hot = float(np.sum(st["ms_frozen_pool"]))
        for _ in range(20):
            st, out = solve(pf, st, -1.0)
        assert out["thawed_fraction"] < hot
        assert float(np.sum(st["ms_frozen_pool"])) > frozen_pool_hot
        assert out["total_pool"] + float(st["cumulative_emissions"]) == pytest.approx(
            800.0, abs=1e-8)

    def test_zonal_distribution_orders_thaw(self, solve):
        st_n, _ = run_years(solve, Permafrost(n_bands=10, zonal_pool_distribution=-1.0),
                            np.full(30, 2.0))
        st_s, _ = run_years(solve, Permafrost(n_bands=10, zonal_pool_distribution=1.0),
                            np.full(30, 2.0))
        assert st_s["cumulative_emissions"] > st_n["cumulative_emissions"]

    def test_band_fractions_normalised(self):
        for d in (-1.0, -0.5, 0.0, 0.5, 1.0):
            f = Permafrost(zonal_pool_distribution=d)._band_fractions()
            assert f.sum() == pytest.approx(1.0, abs=1e-12)
            assert np.all(f >= 0.0)


# -- the component against the JAX package, members differing --------------

B = 5


@pytest.mark.parametrize("moisture", [0.0, 0.4], ids=["dry", "moist"])
def test_batched_solve_matches_jax_members(moisture):
    rng = np.random.default_rng(11)
    swept = {
        "arctic_amplification": rng.uniform(1.5, 2.5, B),
        "melting_temp_max": rng.uniform(8.0, 14.0, B),
        "seasonal_amplitude": rng.uniform(3.0, 7.0, B),
        "soilwater_m": rng.uniform(0.01, 0.04, B),
        "q10_alpha_peat_aerob": rng.uniform(250.0, 350.0, B),
        "thaw_exp_peat": rng.uniform(0.8, 1.3, B),
        "ch4_oxidation_ms": rng.uniform(0.1, 0.4, B),
    }
    fixed = {"n_bands": 12, "anaerob_moistsens_ms": moisture}
    # warming to 5-8 K, then cooling: thaw and refreeze both run
    years = 40
    temps = np.concatenate([
        np.linspace(0.0, 1.0, 30)[:, None] * rng.uniform(5.0, 8.0, B)[None],
        np.linspace(6.0, -1.0, years - 30)[:, None] * np.ones(B)[None],
    ])
    port = Permafrost(**fixed).with_params(
        {k: torch.tensor(v, dtype=torch.float64) for k, v in swept.items()})
    state = {k: torch.as_tensor(np.asarray(v, dtype=np.float64))
             for k, v in port.create_initial_state().items()}
    outs = []
    for k in range(years):
        state, out = port.solve_permafrost(state, torch.tensor(temps[k]), 1.0)
        outs.append(out)
    for m in range(B):
        ref = JaxPermafrost(**fixed, **{k: float(v[m]) for k, v in swept.items()})
        st = ref.create_initial_state()
        for k in range(years):
            st, want = ref.solve_permafrost(st, float(temps[k, m]), 1.0)
            for key, value in want.items():
                np.testing.assert_allclose(outs[k][key][m].item(), value, rtol=1e-12,
                                           atol=1e-12, err_msg=f"{key} year {k} member {m}")
        for key, value in st.items():
            got = state[key] if state[key].dim() == 0 else state[key][m]
            np.testing.assert_allclose(got.numpy(), value, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{key} member {m}")
    assert outs[-1]["thawed_fraction"].min().item() > 0.0  # something thawed


# -- tests/test_permafrost.py's engine cases --------------------------------

def permafrost_model(years, temps):
    """``tests/test_permafrost.py::_build_permafrost_model`` in the port."""
    from rscm_tpu_torch.core import ModelBuilder, TimeAxis, Timeseries, VariableSchema
    from rscm_tpu_torch.core.spatial import ScalarGrid

    schema = VariableSchema()
    schema.add_variable("Surface Temperature", "K")
    for name, unit in (("Emissions|CO2|Permafrost", "GtC/yr"),
                       ("Emissions|CH4|Permafrost", "Mt CH4/yr"),
                       ("Permafrost|Thawed Area Fraction", "1"),
                       ("Permafrost|Total Pool", "GtC")):
        schema.add_variable(name, unit)
    ta = TimeAxis.from_values(years)
    return (
        ModelBuilder()
        .with_time_axis(ta)
        .with_schema(schema)
        .with_component(Permafrost(n_bands=8))
        .with_exogenous_variable(
            "Surface Temperature",
            Timeseries(np.asarray(temps)[:, None], ta, ScalarGrid(), "K"))
        .build()
    )


def series(model, name):
    return np.asarray(model.collection.get_data(name).values()).ravel()


def test_year_loop_matches_step_by_step_executor():
    years = np.arange(2000.0, 2051.0)
    temps = np.linspace(0.0, 4.0, len(years))
    host = permafrost_model(years, temps)
    host.run(compiled=False, device="cpu")
    loop = permafrost_model(years, temps)
    loop.run(device="cpu")
    for var in ("Emissions|CO2|Permafrost", "Emissions|CH4|Permafrost",
                "Permafrost|Total Pool"):
        np.testing.assert_allclose(series(loop, var)[1:], series(host, var)[1:],
                                   rtol=1e-9, atol=1e-12)
    assert np.nanmax(series(loop, "Emissions|CO2|Permafrost")) > 0.1


def test_coupled_graph_permafrost_raises_co2_and_ch4():
    years = np.arange(1850.0, 1981.0)
    emissions = idealised_emissions(years)
    for name in ("Emissions|SOx", "Emissions|BC", "Emissions|OC"):
        values, unit = emissions[name]
        emissions[name] = (np.zeros_like(values), unit)
    base = build_magicc_model(years=years, emissions=emissions)
    base.run(device="cpu")
    perma = build_magicc_model(
        years=years, emissions=emissions, include_permafrost=True,
        permafrost_params={"n_bands": 8, "arctic_amplification": 3.0,
                           "melting_temp_min": 0.2, "melting_temp_max": 2.0})
    perma.run(device="cpu")
    assert np.nanmax(series(perma, "Emissions|CO2|Permafrost")) > 0.0
    for gas in ("CO2", "CH4"):
        name = f"Atmospheric Concentration|{gas}"
        assert series(perma, name)[-1] > series(base, name)[-1]


def test_ensemble_amplification_orders_release():
    years = np.arange(2000.0, 2041.0)
    runner = EnsembleRunner(permafrost_model(years, np.linspace(0.0, 3.0, len(years))),
                            device="cpu")
    params = runner.batched_params(
        {"Permafrost.arctic_amplification": np.linspace(1.2, 2.5, 16)})
    out = runner.run(params, out_vars=["Emissions|CO2|Permafrost"])
    final = np.nan_to_num(out["Emissions|CO2|Permafrost"].numpy()[:, -1]).ravel()
    assert out["Emissions|CO2|Permafrost"].shape[0] == 16
    assert final[-1] > final[0] > 0.0


# -- the full-options MAGICC graph --------------------------------------------

YEARS = np.arange(1850.0, 1911.0)
FULL = {"include_permafrost": True, "include_slr": True}
OUT = ["Surface Temperature", "Sea Level Rise", "Sea Level Rise|Antarctica|SID",
       "Atmospheric Concentration|CO2", "Atmospheric Concentration|CH4",
       "Emissions|CO2|Permafrost", "Emissions|CH4|Permafrost", "Permafrost|Total Pool"]


def trajectories(model):
    return {item.name: np.asarray(model.collection.get_data(item.name).values())
            for item in model.collection}


def permafrost_balance(out, years):
    """Total pool plus cumulative emissions per member and year, GtC, from
    ``{name: (B, n_steps, 1)}`` outputs (row N+1 holds step N's rates)."""
    dt = np.diff(years)[None, :]
    co2 = np.asarray(out["Emissions|CO2|Permafrost"])[:, 1:, 0]
    ch4 = np.asarray(out["Emissions|CH4|Permafrost"])[:, 1:, 0] / MT_CH4_PER_GTC
    emitted = np.cumsum((co2 + ch4) * dt, axis=1)
    return np.asarray(out["Permafrost|Total Pool"])[:, 1:, 0] + emitted


def test_full_options_graph_single_member_matches_jax():
    port = build_magicc_model(years=YEARS, **FULL)
    port.run(device="cpu")
    got = trajectories(port)
    ref = jax_build(years=YEARS, **FULL)
    ref.run()
    want = trajectories(ref)
    assert set(got) == set(want)
    assert {"Sea Level Rise", "Permafrost|Total Pool"} <= set(got)
    for name, values in got.items():
        np.testing.assert_allclose(values, want[name], rtol=1e-9, atol=1e-12, err_msg=name)
    assert np.isfinite(got["Sea Level Rise"][1:]).all()


def test_full_options_graph_ensemble_matches_jax():
    rng = np.random.default_rng(3)
    swept = {
        "ClimateUDEB.ecs": rng.uniform(1.8, 5.5, 16),
        "Permafrost.arctic_amplification": rng.uniform(1.5, 2.5, 16),
        "SeaLevelRise.ais_sid_basalmelt": rng.uniform(7.0, 16.0, 16),
    }
    ref = jax_build(years=YEARS, **FULL)
    jax_runner = JaxEnsembleRunner(ref)
    want = jax_runner.run(jax_runner.batched_params(swept), out_vars=OUT)
    model = build_magicc_model(years=YEARS, **FULL)
    apply_static_params(model, static_params_from_jax(ref))
    runner = EnsembleRunner(model, device="cpu")
    params = params_from_jax(jax_runner.program.gather_params(), swept,
                             node_names=runner.program.node_names(), device="cpu")
    got = runner.run(params, out_vars=OUT)
    for name in OUT:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-8,
                                   atol=1e-10, err_msg=name)
    balance = permafrost_balance(got, YEARS)
    assert np.abs(balance - 800.0).max() < CONSERVATION_GTC
    assert got["Emissions|CO2|Permafrost"][:, -1].max() > 0.0
    full = runner.run(params, stream=False)
    for name in OUT:
        assert torch.equal(got[name].nan_to_num(-1.0), full[name].nan_to_num(-1.0)), name


def test_full_options_step_by_step_executor_matches_year_loop():
    years = YEARS[:31]
    loop = build_magicc_model(years=years, **FULL)
    loop.run(device="cpu")
    host = build_magicc_model(years=years, **FULL)
    host.run(compiled=False, device="cpu")
    want = trajectories(loop)
    for name, values in trajectories(host).items():
        np.testing.assert_allclose(values, want[name], rtol=1e-9, atol=1e-12, err_msg=name)


def test_static_params_carry_across():
    ref = jax_build(years=YEARS[:5], **FULL, permafrost_params={"n_bands": 7},
                    slr_params={"ais_sid_parameterisation": "deconto",
                                "max_history_steps": 40})
    model = build_magicc_model(years=YEARS[:5], **FULL)
    apply_static_params(model, static_params_from_jax(ref))
    comps = {type(c).__name__: c for c in model.graph.nodes}
    assert comps["Permafrost"].n_bands == 7
    assert comps["SeaLevelRise"].ais_sid_parameterisation == "deconto"
    assert comps["SeaLevelRise"].max_history_steps == 40
    model.run(device="cpu")
    assert np.isfinite(series(model, "Sea Level Rise")[1:]).all()
    assert importlib.import_module("rscm_tpu_torch.magicc").SeaLevelRise is type(
        comps["SeaLevelRise"])


# -- the xmath helpers the two modules use ----------------------------------

def test_xmath_helpers_follow_numpy_on_members():
    """``tile`` / ``repeat`` act on the last axis, as numpy's do on the one
    member the JAX package sees; ``interp`` clamps at both ends; a tensor
    predicate with host-scalar branches selects in float64."""
    from rscm_tpu_torch.core import xmath as xm

    rng = np.random.default_rng(2)
    rows = rng.normal(size=(3, 5))
    t = torch.tensor(rows)
    for m in range(3):
        np.testing.assert_array_equal(xm.tile(t, 4)[m].numpy(), np.tile(rows[m], 4))
        np.testing.assert_array_equal(xm.repeat(t, 4)[m].numpy(), np.repeat(rows[m], 4))
    np.testing.assert_array_equal(xm.tile(rows[0], 2), np.tile(rows[0], 2))
    xp, fp = np.array([0.0, 0.5, 2.0, 3.0]), np.array([1.0, -2.0, 4.0, 4.5])
    x = np.array([-1.0, 0.0, 0.25, 0.5, 1.7, 3.0, 9.0])
    np.testing.assert_allclose(xm.interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp)),
                               np.interp(x, xp, fp), rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(xm.power(torch.tensor(np.abs(rows)), 0.82).numpy(),
                               np.power(np.abs(rows), 0.82), rtol=1e-15)
    np.testing.assert_allclose(xm.sum(t, axis=-1).numpy(), np.sum(rows, axis=-1), rtol=1e-15,
                               atol=1e-15)
    np.testing.assert_array_equal(xm.select(t > 0, t, 0.0).numpy(), np.where(rows > 0, rows, 0.0))
    chosen = xm.where(t > 0, 13.83, 0.0)
    assert chosen.dtype == torch.float64
    assert chosen.max().item() == 13.83
    np.testing.assert_array_equal(xm.clip(t, torch.zeros(3, 1, dtype=torch.float64), 0.5).numpy(),
                                  np.clip(rows, 0.0, 0.5))
