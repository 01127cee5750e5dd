"""Each component of the MAGICC graph alone, through the port and ``rscm_tpu``.

Every component runs in a one-component model whose inputs are exogenous
series drawn from a numpy seed, over a batch of members swept over one or
two of its parameters, through both packages' ``EnsembleRunner`` in
float64.  Tolerances: 1e-12 where the component is polynomial in its
inputs (budget, aerosols, prescribed concentrations: the same operations
in the same order, so only equal expressions' rounding can differ), 1e-9
otherwise (transcendentals, iterated updates, matrix products summed in
another order).  OceanCarbon runs under both engines; its bfloat16 ring
history (stored and read in bfloat16, multiplied in float32) is held at
rtol 1e-5 (a float32 sum of bfloat16 products rounds at ~1e-7 relative;
the margin covers the order of that sum).
"""

import numpy as np
import pytest
import torch

import rscm_tpu.magicc as jax_magicc
import rscm_tpu_torch.magicc as port_magicc
from rscm_tpu.magicc.chemistry.prescribed import (
    apply_prescribed_concentration as jax_prescribed,
)
from rscm_tpu.parallel import EnsembleRunner as JaxEnsembleRunner
from rscm_tpu_torch.core.component import SolveContext
from rscm_tpu_torch.magicc.chemistry.prescribed import apply_prescribed_concentration
from rscm_tpu_torch.parallel import EnsembleRunner
from test_torch_support import build_single

YEARS = np.arange(1850.0, 1900.0)
N = len(YEARS)
B = 8
POLY = dict(rtol=1e-12, atol=1e-12)
TRANSC = dict(rtol=1e-9, atol=1e-12)


def series(seed, lo, hi):
    """A seeded, rising and wiggling series on YEARS between lo and hi."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.0, 1.0, N) ** 1.5
    return lo + (hi - lo) * np.clip(ramp + 0.05 * rng.standard_normal(N), 0.0, 1.0)


def sweep(seed, **ranges):
    rng = np.random.default_rng(seed)
    return {name: rng.uniform(lo, hi, B) for name, (lo, hi) in ranges.items()}


EMISSIONS = {
    "Emissions|CH4": (series(1, 100.0, 350.0), "Mt CH4/yr"),
    "Emissions|N2O": (series(2, 5.0, 10.0), "Mt N/yr"),
    "Emissions|NOx": (series(3, 10.0, 40.0), "Mt N/yr"),
    "Emissions|CO": (series(4, 200.0, 800.0), "Mt CO/yr"),
    "Emissions|NMVOC": (series(5, 60.0, 180.0), "Mt NMVOC/yr"),
    "Emissions|SOx": (series(6, 0.0, 100.0), "Mt S/yr"),
    "Emissions|BC": (series(7, 1.0, 7.0), "Mt BC/yr"),
    "Emissions|OC": (series(8, 5.0, 30.0), "Mt OC/yr"),
    "EESC": (series(9, 1000.0, 2000.0), "ppt"),
    "Surface Temperature": (series(10, 0.0, 1.5), "K"),
    "Sea Surface Temperature": (series(11, 0.0, 1.2), "K"),
    "Atmospheric Concentration|CO2": (series(12, 280.0, 420.0), "ppm"),
    "Atmospheric Concentration|CH4": (series(13, 790.0, 1800.0), "ppb"),
    "Atmospheric Concentration|N2O": (series(14, 275.0, 330.0), "ppb"),
    "Emissions|CO2|Fossil": (series(15, 0.0, 10.0), "GtC/yr"),
    "Emissions|CO2|Land Use": (series(16, 0.0, 1.5), "GtC/yr"),
    "Carbon Flux|Terrestrial": (series(17, -1.0, 3.0), "GtC/yr"),
    "Carbon Flux|Ocean": (series(18, 0.0, 2.5), "GtC/yr"),
}


def ch4_magicc7(pkg):
    years = np.arange(1990.0, 2040.0)
    conc = series(20, 1700.0, 1900.0)
    return pkg.CH4Chemistry.magicc7(
        years, conc, EMISSIONS["Emissions|CH4"][0], EMISSIONS["Emissions|NOx"][0],
        EMISSIONS["Emissions|CO"][0], EMISSIONS["Emissions|NMVOC"][0],
        temperatures=EMISSIONS["Surface Temperature"][0],
    )


def n2o_magicc7(pkg):
    years = np.arange(1990.0, 2040.0)
    return pkg.N2OChemistry.magicc7(years, series(21, 300.0, 330.0),
                                    EMISSIONS["Emissions|N2O"][0])


#: (id, component factory, state initial values, swept parameters, outputs, tolerance)
CASES = [
    ("budget", lambda m: m.CO2Budget(), {"Atmospheric Concentration|CO2": 284.0},
     {"gtc_per_ppm": (2.0, 2.2)},
     ["Atmospheric Concentration|CO2", "Emissions|CO2|Net", "Airborne Fraction|CO2"], POLY),
    ("aerosol_direct", lambda m: m.AerosolDirect(), {},
     {"sox_coefficient": (-0.005, -0.002), "bc_coefficient": (0.005, 0.01)},
     ["Effective Radiative Forcing|Aerosol|Direct"], POLY),
    ("aerosol_indirect", lambda m: m.AerosolIndirect(), {},
     {"cloud_albedo_coefficient": (-1.5, -0.5), "reference_burden": (30.0, 70.0)},
     ["Effective Radiative Forcing|Aerosol|Indirect"], TRANSC),
    ("ozone", lambda m: m.OzoneForcing(), {},
     {"trop_radeff": (0.02, 0.04), "strat_o3_scale": (-0.006, -0.003)},
     ["Effective Radiative Forcing|O3|Stratospheric",
      "Effective Radiative Forcing|O3|Tropospheric",
      "Effective Radiative Forcing|O3|Temperature Feedback"], TRANSC),
    ("ghg_ipcctar", lambda m: m.GhgForcing(method="Ipcctar"), {},
     {"co2_pi": (270.0, 285.0), "delq2xco2": (3.5, 3.9)},
     ["Effective Radiative Forcing|CO2", "Effective Radiative Forcing|CH4",
      "Effective Radiative Forcing|N2O"], TRANSC),
    ("ghg_olbl", lambda m: m.GhgForcing(method="Olbl"), {},
     {"co2_pi": (270.0, 285.0), "olbl_co2_d1": (5.0, 5.4)},
     ["Effective Radiative Forcing|CO2", "Effective Radiative Forcing|CH4",
      "Effective Radiative Forcing|N2O"], TRANSC),
    ("ch4_reference", lambda m: m.CH4Chemistry(ch4_pi=790.0),
     {"Atmospheric Concentration|CH4": 790.0},
     {"tau_oh": (8.5, 10.0), "natural_emissions": (180.0, 240.0)},
     ["Atmospheric Concentration|CH4", "Lifetime|CH4"], TRANSC),
    ("ch4_magicc7", ch4_magicc7, {"Atmospheric Concentration|CH4": 1700.0},
     {"temp_sensitivity": (0.05, 0.09), "wetland_slope": (10.0, 30.0)},
     ["Atmospheric Concentration|CH4", "Lifetime|CH4"], TRANSC),
    ("n2o_reference", lambda m: m.N2OChemistry(n2o_pi=275.0),
     {"Atmospheric Concentration|N2O": 275.0},
     {"tau_n2o": (120.0, 150.0), "lifetime_feedback": (-0.06, -0.02)},
     ["Atmospheric Concentration|N2O", "Lifetime|N2O"], TRANSC),
    ("n2o_reference_delay3", lambda m: m.N2OChemistry(n2o_pi=275.0, strat_delay=3),
     {"Atmospheric Concentration|N2O": 275.0},
     {"tau_n2o": (120.0, 150.0)},
     ["Atmospheric Concentration|N2O", "Lifetime|N2O"], TRANSC),
    ("n2o_magicc7", n2o_magicc7, {"Atmospheric Concentration|N2O": 300.0},
     {"tau_n2o": (120.0, 150.0)},
     ["Atmospheric Concentration|N2O", "Lifetime|N2O"], TRANSC),
    ("terrestrial", lambda m: m.TerrestrialCarbon(),
     {"Carbon Pool|Plant": 884.86, "Carbon Pool|Detritus": 92.77,
      "Carbon Pool|Soil": 1681.53, "Carbon Pool|Humus": 836.0},
     {"beta": (0.3, 0.9), "npp_temp_sensitivity": (0.005, 0.02)},
     ["Carbon Flux|Terrestrial", "Carbon Pool|Plant", "Carbon Pool|Detritus",
      "Carbon Pool|Soil", "Carbon Pool|Humus"], TRANSC),
]

OCEAN_INITIAL = {"Ocean Surface pCO2": 284.0, "Cumulative Ocean Uptake": 0.0}
OCEAN_SWEEP = {"gas_exchange_scale": (1.5, 2.2), "temp_sensitivity": (0.02, 0.05)}
OCEAN_OUT = ["Ocean Surface pCO2", "Cumulative Ocean Uptake", "Carbon Flux|Ocean"]
BF16 = dict(rtol=1e-5, atol=1e-9)
#: (id, OceanCarbon parameters, engine it resolves to, tolerance)
OCEAN_CASES = [
    ("auto_default_window", {}, "expsum", TRANSC),
    ("expsum", {"engine": "expsum", "max_history_months": 12 * (N + 1)}, "expsum", TRANSC),
    ("expsum_2d_bern", {"engine": "expsum", "model": "2D-BERN", "irf_switch_time": 9.9,
                        "irf_early": "2D-BERN", "irf_late": "2D-BERN",
                        "max_history_months": 12 * (N + 1)}, "expsum", TRANSC),
    ("ring", {"engine": "ring", "max_history_months": 12 * (N + 1)}, "ring", TRANSC),
    ("ring_wraps", {"max_history_months": 240}, "ring", TRANSC),
    ("ring_bfloat16", {"engine": "ring", "max_history_months": 12 * (N + 1),
                       "history_dtype": "bfloat16"}, "ring", BF16),
    ("ring_float32_storage", {"engine": "ring", "max_history_months": 12 * (N + 1),
                              "history_dtype": "float32"}, "ring", TRANSC),
]


def ocean(params):
    def make(m):
        p = dict(params)
        for key in ("irf_early", "irf_late"):
            if key in p:
                p[key] = m.carbon.ocean.OCEAN_CARBON_PRESETS[p[key]][key]
        return m.OceanCarbon(**p)

    return make


def run_both(make, initial, swept, outputs):
    """Outputs of the B-member ensemble in both packages, as numpy."""
    names = {k: v for k, v in EMISSIONS.items() if k not in initial}
    comp_name = type(make(port_magicc)).__name__
    overrides = {f"{comp_name}.{k}": v for k, v in swept.items()}

    jax_model = build_single("rscm_tpu", make(jax_magicc), YEARS, names, initial)
    jax_runner = JaxEnsembleRunner(jax_model)
    jax_out = jax_runner.run(jax_runner.batched_params(overrides), out_vars=outputs)

    model = build_single("rscm_tpu_torch", make(port_magicc), YEARS, names, initial)
    runner = EnsembleRunner(model, device="cpu")
    out = runner.run(runner.batched_params(overrides), out_vars=outputs)
    return {k: np.asarray(jax_out[k]) for k in outputs}, {k: out[k].numpy() for k in outputs}


def assert_outputs(want, got, tol):
    assert set(want) == set(got)
    for name in want:
        assert got[name].shape == want[name].shape == (B, N, want[name].shape[-1]), name
        assert np.isfinite(got[name][:, 1:]).all(), name
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_component_matches_jax(case):
    _, make, initial, ranges, outputs, tol = case
    want, got = run_both(make, initial, sweep(30, **ranges), outputs)
    assert_outputs(want, got, tol)


@pytest.mark.parametrize("case", OCEAN_CASES, ids=[c[0] for c in OCEAN_CASES])
def test_ocean_carbon_matches_jax(case):
    _, params, engine, tol = case
    make = ocean(params)
    assert make(port_magicc).resolved_engine() == make(jax_magicc).resolved_engine() == engine
    want, got = run_both(make, OCEAN_INITIAL, sweep(31, **OCEAN_SWEEP), OCEAN_OUT)
    assert_outputs(want, got, tol)


def test_ocean_expsum_tables_match_jax():
    """The host fit of the exp-sum tail is the reference's, table for table."""
    port = port_magicc.OceanCarbon()._expsum_tables()
    ref = jax_magicc.OceanCarbon()._expsum_tables()
    for key in ("coef", "q", "q_steps", "tail_eval", "young_w_of", "exit_w_of"):
        np.testing.assert_array_equal(np.asarray(port[key]), np.asarray(ref[key]), err_msg=key)
    assert port["young"] == ref["young"] == 36
    assert port["fit_rel_error"] < 1e-8


@pytest.mark.parametrize("engine", ["ring", "expsum"])
def test_ocean_final_state_matches_jax(engine):
    """Model.run writes the final flux history (and tail) back in the host
    layout, as the reference's compiled run does."""
    params = {"engine": engine, "max_history_months": 12 * (N + 1)}
    names = {k: v for k, v in EMISSIONS.items()
             if k in ("Atmospheric Concentration|CO2", "Sea Surface Temperature")}
    jax_model = build_single("rscm_tpu", ocean(params)(jax_magicc), YEARS, names, OCEAN_INITIAL)
    jax_model.run()
    model = build_single("rscm_tpu_torch", ocean(params)(port_magicc), YEARS, names,
                         OCEAN_INITIAL)
    model.run(device="cpu")
    node = next(n for n, s in model.component_states.items() if s is not None)
    want, got = jax_model.component_states[node], model.component_states[node]
    assert set(got) == set(want)
    for key in want:
        assert np.shape(got[key]) == np.shape(want[key]), key
        np.testing.assert_allclose(got[key], np.asarray(want[key]), err_msg=key, **TRANSC)


@pytest.mark.parametrize("tensor_input", [False, True])
def test_prescribed_concentration_matches_jax(tensor_input):
    """The switch-year select, step by step across the switch, 1e-12."""
    years = np.arange(2005.0, 2025.0)
    prescribed = series(22, 1700.0, 1900.0)[: len(years)]
    computed = np.random.default_rng(23).uniform(1600.0, 2000.0, (len(years), B))
    for idx in range(len(years) - 1):
        ctx = SolveContext(float(years[idx]), float(years[idx + 1]), idx)
        value = torch.as_tensor(computed[idx]) if tensor_input else float(computed[idx, 0])
        got = apply_prescribed_concentration(ctx, value, prescribed, 2015.0)
        want = jax_prescribed(ctx, np.asarray(value), prescribed, 2015.0)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **POLY)
        if years[idx + 1] <= 2015.0:
            np.testing.assert_array_equal(np.broadcast_to(np.asarray(got), np.shape(want)),
                                          prescribed[idx + 1])
