"""Sea-level rise (module_14, beyond the reference) through the port.

- Every case of ``tests/test_slr.py`` runs through the port's component,
  on host floats (numpy) and on one-member tensors (torch), and its engine
  cases through the port's year loop and step-by-step executor.
- ``SeaLevelRise.solve_slr`` over a batch of members whose swept
  parameters, temperatures and heat contents differ agrees with the JAX
  component run member by member within 1e-12, for both Antarctic
  discharge methods (Levermann's impulse response and DeConto's
  threshold).
- The reverse-mode gradient of the last year's ``Sea Level Rise`` with
  respect to ``ClimateUDEB.ecs`` through the full-options MAGICC graph
  agrees with ``jax.grad`` within 1e-7.  The aerosol emissions are zeroed,
  as in the JAX package's coupled SLR tests: with them the global
  temperature falls to or below zero in some year, where the JAX
  package's gradient is NaN (its ``maximum`` passes the infinite slope of
  ``x ** 0.782`` at zero on as ``0 * inf``); the port's gradient with the
  default emissions is checked to be finite.
"""

import numpy as np
import pytest
import torch

from rscm_tpu.magicc import SeaLevelRise as JaxSeaLevelRise
from rscm_tpu_torch.core import ModelBuilder, TimeAxis, Timeseries, VariableSchema
from rscm_tpu_torch.core.spatial import ScalarGrid
from rscm_tpu_torch.magicc import SeaLevelRise
from rscm_tpu_torch.magicc.coupled import _SLR_VARS, build_magicc_model, idealised_emissions
from rscm_tpu_torch.parallel import EnsembleRunner


def numpy_of(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
        return x[0] if x.ndim >= 1 else x
    return np.asarray(x)


@pytest.fixture(params=["host", "tensor"])
def drive(request):
    """``tests/test_slr.py::drive`` on host floats or one-member tensors."""
    tensor = request.param == "tensor"

    def run(slr, years, temps, ohcs, dt=1.0):
        st = slr.create_initial_state()
        outs = []
        for k, yr in enumerate(np.atleast_1d(years)):
            t, ohc = float(temps[k]), float(ohcs[k])
            if tensor:
                t, ohc = (torch.tensor([v], dtype=torch.float64) for v in (t, ohc))
            st, out = slr.solve_slr(st, t, ohc, float(yr), k, dt)
            outs.append({k2: float(numpy_of(v)) for k2, v in out.items()})
        return {k: numpy_of(v) for k, v in st.items()}, outs

    return run


def warming_scenario(years, t_max=4.0, ohc_max=2e10, ramp_from=1900.0):
    years = np.asarray(years)
    f = np.maximum(0.0, (years - ramp_from) / max(years[-1] - ramp_from, 1.0))
    return t_max * f, ohc_max * f


# -- tests/test_slr.py's behaviour cases ------------------------------------

class TestSpecBehaviour:
    def test_zero_forcing_is_inert(self, drive):
        years = np.arange(1850.0, 2001.0)
        _, outs = drive(SeaLevelRise(max_history_steps=200), years,
                        np.zeros_like(years), np.zeros_like(years))
        final = outs[-1]
        for key in ("expansion", "glaciers", "gis_smb", "gis_sid", "ais_smb", "ais_sid",
                    "landwater"):
            assert final[key] == pytest.approx(0.0, abs=1e-9), key
        assert final["semiempirical"] == pytest.approx(0.3353 * 0.5, rel=1e-9)

    def test_warming_raises_all_contributors(self, drive):
        years = np.arange(1850.0, 2101.0)
        temps, ohcs = warming_scenario(years)
        _, outs = drive(SeaLevelRise(max_history_steps=len(years) + 1), years, temps, ohcs)
        final = outs[-1]
        assert final["expansion"] > 100.0
        assert final["glaciers"] > 50.0
        assert final["gis_smb"] > 1.0
        assert final["gis_sid"] > 10.0
        assert final["ais_sid"] > 10.0
        assert final["total"] == pytest.approx(
            sum(final[k] for k in ("expansion", "glaciers", "gis_smb", "gis_sid",
                                   "ais_smb", "ais_sid", "landwater")), rel=1e-12)
        totals = [o["total"] for o in outs[100:]]
        assert all(b >= a - 1e-9 for a, b in zip(totals, totals[1:]))

    def test_start_year_gating(self, drive):
        years = np.arange(1850.0, 2101.0)
        temps, ohcs = warming_scenario(years, ramp_from=1850.0)
        _, outs = drive(SeaLevelRise(max_history_steps=len(years) + 1), years, temps, ohcs)
        by_year = dict(zip(years, outs))
        assert by_year[1999.0]["gis_sid"] == pytest.approx(0.0, abs=1e-12)
        assert by_year[2010.0]["gis_sid"] > 0.0
        assert by_year[1979.0]["ais_smb"] == pytest.approx(0.0, abs=1e-12)
        assert by_year[1964.0]["gis_smb"] == pytest.approx(0.0, abs=1e-12)

    def test_gis_sid_reservoir_bounded(self, drive):
        years = np.arange(2000.0, 2501.0)
        st, outs = drive(SeaLevelRise(max_history_steps=len(years) + 1), years,
                         np.full_like(years, 10.0), np.zeros_like(years))
        assert st["gis_vol_low"] >= 0.0
        assert st["gis_vol_high"] >= 0.0
        cap = (0.5 * (53.63 - 35.98) + 35.98) * 5.0
        assert outs[-1]["gis_sid"] <= cap + 1e-6

    def test_deconto_fast_rate_threshold(self, drive):
        years = np.arange(1950.0, 2101.0)
        make = lambda: SeaLevelRise(ais_sid_parameterisation="deconto")  # noqa: E731
        _, outs_b = drive(make(), years, np.full_like(years, 0.9), np.zeros_like(years))
        _, outs_a = drive(make(), years, np.full_like(years, 1.2), np.zeros_like(years))
        rate_b = outs_b[-1]["ais_sid"] - outs_b[-51]["ais_sid"]
        rate_a = outs_a[-1]["ais_sid"] - outs_a[-51]["ais_sid"]
        assert rate_a - rate_b > 0.5 * 13.83 * 50

    def test_levermann_delays(self, drive):
        years_short = np.arange(1850.0, 1876.0)
        years_long = np.arange(1850.0, 1916.0)
        t_s = np.full_like(years_short, 2.0)
        t_s[0] = 0.0
        t_l = np.full_like(years_long, 2.0)
        t_l[0] = 0.0
        _, outs_s = drive(SeaLevelRise(max_history_steps=100), years_short, t_s,
                          np.zeros_like(years_short))
        _, outs_l = drive(SeaLevelRise(max_history_steps=100), years_long, t_l,
                          np.zeros_like(years_long))
        assert 0.0 < outs_s[-1]["ais_sid"] < outs_l[-1]["ais_sid"]

    def test_landwater_depletion(self, drive):
        years = np.arange(1900.0, 2301.0)
        slr = SeaLevelRise(max_history_steps=len(years) + 1, landwater_enabled=True,
                           landwater_mm_per_year=np.full(len(years), 0.4),
                           landwater_maxvolume_mm=100.0)
        _, outs = drive(slr, years, np.zeros_like(years), np.zeros_like(years))
        lw = [o["landwater"] for o in outs]
        assert lw[199] == pytest.approx(0.4 * 199, rel=1e-9)
        assert lw[-1] < 100.0 + 1e-6

    def test_levermann_subannual_axis_one_slot_per_step(self, drive):
        years = np.arange(2000.0, 2031.0, 0.5)
        slr = SeaLevelRise(max_history_steps=len(years) + 1, ais_sid_startyear=2000.0)
        slr.validate_time_axis(TimeAxis.from_values(years))
        assert slr.axis_dt() == 0.5
        temps = np.linspace(0.0, 3.0, len(years))
        st, outs = drive(slr, years, temps, np.zeros_like(years), dt=0.5)
        hist = np.asarray(st["t_hist"])
        assert len(hist[hist != 0.0]) >= len(years) - 2
        assert outs[-1]["ais_sid"] > 0.0
        years_a = np.arange(2000.0, 2031.0)
        slr_a = SeaLevelRise(max_history_steps=len(years_a) + 1, ais_sid_startyear=2000.0)
        _, outs_a = drive(slr_a, years_a, np.linspace(0.0, 3.0, len(years_a)),
                          np.zeros_like(years_a))
        assert outs[-1]["ais_sid"] == pytest.approx(outs_a[-1]["ais_sid"], rel=0.35)

    def test_nonuniform_axis_raises_at_build(self):
        years = np.concatenate([np.arange(2000.0, 2010.0), np.arange(2010.0, 2030.0, 2.0)])
        temps = np.zeros(len(years))
        with pytest.raises(ValueError, match="uniform time axis"):
            slr_model(years, temps, temps)

    def test_semiempirical_rate(self, drive):
        years = np.arange(1950.0, 2101.0)
        temps = np.where(years >= 2000.0, 1.0, 0.0)
        _, outs = drive(SeaLevelRise(max_history_steps=200), years, temps,
                        np.zeros_like(years))
        assert outs[-1]["semiempirical"] == pytest.approx(0.3353 * 1.5 * 101, rel=1e-9)


def slr_model(years, temps, ohcs, **slr_kwargs):
    """``tests/test_slr.py::_build_slr_model`` in the port."""
    schema = VariableSchema()
    schema.add_variable("Surface Temperature", "K")
    schema.add_variable("Ocean Heat Content", "J/m^2")
    for name, unit in _SLR_VARS:
        schema.add_variable(name, unit)
    ta = TimeAxis.from_values(years)
    return (
        ModelBuilder()
        .with_time_axis(ta)
        .with_schema(schema)
        .with_component(SeaLevelRise(max_history_steps=len(years) + 1, **slr_kwargs))
        .with_exogenous_variable(
            "Surface Temperature", Timeseries(np.asarray(temps)[:, None], ta, ScalarGrid(), "K"))
        .with_exogenous_variable(
            "Ocean Heat Content",
            Timeseries(np.asarray(ohcs)[:, None], ta, ScalarGrid(), "J/m^2"))
        .build()
    )


def series(model, name):
    return np.asarray(model.collection.get_data(name).values()).ravel()


# -- tests/test_slr.py's engine cases ---------------------------------------

@pytest.mark.parametrize("method", ["levermann", "deconto"])
def test_year_loop_matches_step_by_step_executor(method):
    years = np.arange(1950.0, 2051.0)
    temps, ohcs = warming_scenario(years, ramp_from=1950.0)
    host = slr_model(years, temps, ohcs, ais_sid_parameterisation=method)
    host.run(compiled=False, device="cpu")
    loop = slr_model(years, temps, ohcs, ais_sid_parameterisation=method)
    loop.run(device="cpu")
    for var in ("Sea Level Rise", "Sea Level Rise|Antarctica|SID",
                "Sea Level Rise|Glaciers", "Sea Level Rise|Semi-Empirical"):
        np.testing.assert_allclose(series(loop, var)[1:], series(host, var)[1:],
                                   rtol=1e-9, atol=1e-9, err_msg=var)
    assert np.nanmax(series(loop, "Sea Level Rise")) > 10.0


def test_coupled_magicc_graph():
    years = np.arange(1850.0, 1981.0)
    emissions = idealised_emissions(years)
    for name in ("Emissions|SOx", "Emissions|BC", "Emissions|OC"):
        values, unit = emissions[name]
        emissions[name] = (np.zeros_like(values), unit)
    model = build_magicc_model(years=years, emissions=emissions, include_slr=True)
    model.run(device="cpu")
    total = series(model, "Sea Level Rise")
    expansion = series(model, "Sea Level Rise|Thermal Expansion")
    assert np.isfinite(total[1:]).all()
    assert total[-1] > expansion[-1] * 0.5 > 0.0


def test_ensemble_basal_melt_orders_sea_level():
    years = np.arange(1950.0, 2051.0)
    temps, ohcs = warming_scenario(years, ramp_from=1950.0)
    runner = EnsembleRunner(slr_model(years, temps, ohcs), device="cpu")
    params = runner.batched_params(
        {"SeaLevelRise.ais_sid_basalmelt": np.linspace(7.0, 16.0, 12)})
    out = runner.run(params, out_vars=["Sea Level Rise"])
    assert out["Sea Level Rise"].shape[0] == 12
    final = np.nan_to_num(out["Sea Level Rise"].numpy()[:, -1]).ravel()
    assert final[-1] > final[0] > 0.0


# -- the component against the JAX package, members differing --------------

B = 5


@pytest.mark.parametrize("method", ["levermann", "deconto"])
def test_batched_solve_matches_jax_members(method):
    rng = np.random.default_rng(7)
    swept = {
        "ais_sid_basalmelt": rng.uniform(7.0, 16.0, B),
        "gl_temp_exponent": rng.uniform(0.7, 0.95, B),
        "gis_smb_coef1": rng.uniform(0.01, 0.02, B),
        "ais_smb_sens_exponent": rng.uniform(0.6, 1.0, B),
        "ais_sid_dschrg_sens": rng.uniform(3e-5, 8e-5, B),
        "ais_sid_thresholdtemp": rng.uniform(0.8, 1.6, B),
        "expansion_alpha_eff": rng.uniform(1.2e-4, 1.9e-4, B),
        "semiempi_rate_sens": rng.uniform(0.2, 0.5, B),
    }
    fixed = {"ais_sid_parameterisation": method, "max_history_steps": 200,
             "ais_discharge_startyear": 1870.0}
    years = np.arange(1850.0, 2011.0)
    ramp = np.maximum(0.0, (years - 1860.0) / 150.0)
    temps = ramp[:, None] * rng.uniform(2.0, 4.0, B)[None] + 0.05
    ohcs = ramp[:, None] * rng.uniform(1e10, 3e10, B)[None]
    port = SeaLevelRise(**fixed).with_params(
        {k: torch.tensor(v, dtype=torch.float64) for k, v in swept.items()})
    state = port.create_initial_state()
    outs = []
    for k, yr in enumerate(years):
        state, out = port.solve_slr(state, torch.tensor(temps[k]), torch.tensor(ohcs[k]),
                                    float(yr), k, 1.0)
        outs.append(out)
    for m in range(B):
        ref = JaxSeaLevelRise(**fixed, **{k: float(v[m]) for k, v in swept.items()})
        st = ref.create_initial_state()
        for k, yr in enumerate(years):
            st, want = ref.solve_slr(st, float(temps[k, m]), float(ohcs[k, m]), float(yr), k,
                                     1.0)
            for key, value in want.items():
                got = outs[k][key]
                got = got[m].item() if isinstance(got, torch.Tensor) and got.dim() else float(got)
                np.testing.assert_allclose(got, value, rtol=1e-12, atol=1e-12,
                                           err_msg=f"{key} {yr} member {m}")
        for key, value in st.items():
            got = state[key]
            got = got[m] if isinstance(got, torch.Tensor) and got.dim() == np.ndim(value) + 1 \
                else got
            np.testing.assert_allclose(np.asarray(got), value, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{key} member {m}")
    assert float(outs[-1]["ais_sid"].min()) != 0.0


# -- the gradient through the full-options graph ----------------------------

GRAD_YEARS = np.arange(1850.0, 1871.0)


def full_options(pkg, emissions=None):
    import importlib

    build = importlib.import_module(f"{pkg}.magicc.coupled").build_magicc_model
    return build(years=GRAD_YEARS, emissions=emissions, include_permafrost=True,
                 include_slr=True, ocean_params={"history_dtype": "float32"})


def port_gradient(emissions=None):
    from rscm_tpu_torch.calibrate import CompiledModelRunner

    runner = CompiledModelRunner(full_options("rscm_tpu_torch", emissions),
                                 {"ecs": "ClimateUDEB.ecs"}, ["Sea Level Rise"], device="cpu")
    theta = torch.tensor([3.0], dtype=torch.float64, requires_grad=True)
    runner.trajectories_fn()(theta)["Sea Level Rise"][-1, 0].backward()
    return theta.grad.numpy()


def test_sea_level_gradient_matches_jax_grad():
    import jax

    from rscm_tpu.calibrate import CompiledModelRunner as JaxRunner

    emissions = idealised_emissions(GRAD_YEARS)
    for name in ("Emissions|SOx", "Emissions|BC", "Emissions|OC"):
        values, unit = emissions[name]
        emissions[name] = (np.zeros_like(values), unit)
    fn = JaxRunner(full_options("rscm_tpu", emissions), {"ecs": "ClimateUDEB.ecs"},
                   ["Sea Level Rise"]).trajectories_fn()
    want = np.asarray(jax.grad(lambda th: fn(th)["Sea Level Rise"][-1, 0])(np.array([3.0])))
    got = port_gradient(emissions)
    assert np.all(np.isfinite(want)) and abs(want[0]) > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-7)


def test_sea_level_gradient_is_finite_with_aerosols():
    assert np.all(np.isfinite(port_gradient()))
