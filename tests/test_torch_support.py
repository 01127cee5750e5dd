"""Shared builders for the ``rscm_tpu_torch`` parity tests (no tests here).

The same ClimateUDEB model, driven by an exogenous effective radiative
forcing, is built in either package from the same numpy inputs.
"""

import importlib

import numpy as np

UDEB_OUTPUTS = [
    "Surface Temperature", "Heat Uptake", "Ocean Heat Content",
    "Sea Surface Temperature",
]


def build_udeb(pkg, years, erf, *, from_bounds=False, **params):
    """ClimateUDEB on ``years`` driven by ``erf``, built with package
    ``pkg`` (``"rscm_tpu"`` or ``"rscm_tpu_torch"``).  ``from_bounds``
    builds the time axis as the golden regression tests do."""
    core = importlib.import_module(f"{pkg}.core")
    spatial = importlib.import_module(f"{pkg}.core.spatial")
    magicc = importlib.import_module(f"{pkg}.magicc")
    years = np.asarray(years, dtype=np.float64)
    if from_bounds:
        axis = core.TimeAxis.from_bounds(np.concatenate([years, [years[-1] + 1.0]]))
    else:
        axis = core.TimeAxis.from_values(years)
    schema = core.VariableSchema()
    schema.add_variable("Effective Radiative Forcing", "W/m^2")
    schema.add_variable("Surface Temperature", "K", core.GridType.FourBox)
    schema.add_variable("Heat Uptake", "W/m^2")
    schema.add_variable("Ocean Heat Content", "J/m^2")
    schema.add_variable("Sea Surface Temperature", "K")
    return (
        core.ModelBuilder()
        .with_time_axis(axis)
        .with_schema(schema)
        .with_component(magicc.ClimateUDEB(**params))
        .with_exogenous_variable(
            "Effective Radiative Forcing",
            core.Timeseries(
                np.asarray(erf, dtype=np.float64)[:, None], axis, spatial.ScalarGrid(), "W/m^2"
            ),
        )
        .with_initial_values({"Surface Temperature": 0.0})
        .build()
    )


def step_erf(years, level=3.71, step_year=1851.0):
    return np.where(np.asarray(years) >= step_year, level, 0.0)


def values(model, name):
    return np.asarray(model.collection.get_data(name).values())


def build_single(pkg, component, years, exogenous, initial):
    """A one-component model on ``years`` (axis from values) built with
    package ``pkg``: ``exogenous`` maps each input variable to ``(values,
    unit)``; ``initial`` gives the state variables' initial values."""
    core = importlib.import_module(f"{pkg}.core")
    spatial = importlib.import_module(f"{pkg}.core.spatial")
    axis = core.TimeAxis.from_values(np.asarray(years, dtype=np.float64))
    builder = core.ModelBuilder().with_time_axis(axis).with_component(component)
    inputs = set(component.input_names())
    for name, (vals, unit) in exogenous.items():
        if name in inputs:
            builder = builder.with_exogenous_variable(
                name,
                core.Timeseries(np.asarray(vals, dtype=np.float64)[:, None], axis,
                                spatial.ScalarGrid(), unit),
            )
    if initial:
        builder = builder.with_initial_values(dict(initial))
    return builder.build()


def params_from_config(config):
    """MAGICC .CFG keys onto ClimateUDEB parameters (the port's copy of
    ``tests/regression/test_ocean_udeb.py::params_from_config``)."""
    return {
        "ecs": config.get("core_climatesensitivity", 3.0),
        "rf_2xco2": config.get("core_delq2xco2", 3.71),
        "w_initial": config.get("core_initial_upwelling_rate", 3.5),
        "w_variable_fraction": config.get("core_upwelling_variable_part", 0.7),
        "depth_dependent_area": float(config.get("core_ocn_depthdependent", 1)),
        "kappa_dkdt": config.get("core_verticaldiff_top_dkdt", -0.191),
        "land_heat_capacity_enabled": bool(config.get("core_landheatcapacity_apply", 1)),
        "land_hc_eff_thickness": config.get("core_landhc_effthickness", 300.0),
        "k_lg": config.get("core_heatxchange_landground", 0.1),
        "k_ns": config.get("core_heatxchange_northsouth", 0.31),
        "feedback_cumt_sensitivity": config.get("core_feedback_cumtsensitivity", 0.08),
        "feedback_q_sensitivity": config.get("core_feedback_qsensitivity", 7.84e-9),
        "efficacy_apply": config.get("rf_efficacy_apply", 0),
        "prescribed_efficacy_co2": config.get("rf_efficacy_co2", 1.0),
    }


def assert_phased(actual, expected, *, skip=5, shock_end=25, converge_start=55,
                  shock_rtol=3e-2, converge_rtol=2e-2, final_rtol=2e-2, final_years=20,
                  atol=1e-6, name=""):
    """The phase windows and bounds of ``tests/regression/helpers.py::
    assert_allclose_phased`` (indices < skip ignored; shock and transition
    at shock_rtol, converge at converge_rtol, the last ``final_years`` at
    final_rtol), without writing rows to the parity report."""
    actual = np.asarray(actual).reshape(len(actual), -1)[:, 0]
    expected = np.asarray(expected)
    n = len(actual)
    assert len(expected) == n, f"{name}: length mismatch {n} vs {len(expected)}"
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(np.abs(expected) > atol, (actual - expected) / expected, 0.0)
    s_end, c_start, f_start = min(shock_end, n), min(converge_start, n), max(skip, n - final_years)
    phases = [("shock", skip, s_end, shock_rtol), ("transition", s_end, c_start, shock_rtol),
              ("converge", c_start, f_start, converge_rtol), ("final", f_start, n, final_rtol)]
    failures = [
        f"{label}: max rel err {np.max(np.abs(rel[a:b])):.3%} > {rtol:.3%}"
        for label, a, b, rtol in phases
        if a < b and np.max(np.abs(rel[a:b])) > rtol
    ]
    assert not failures, f"{name}: " + "; ".join(failures)


#: the flagship graph's variables (``bench.py:123-180``)
FLAGSHIP_VARIABLES = [
    ("Emissions|CO2|Anthropogenic", "GtC / yr"),
    ("Surface Temperature", "K"),
    ("Deep Ocean Temperature", "K"),
    ("Atmospheric Concentration|CO2", "ppm"),
    ("Cumulative Emissions|CO2", "Gt C"),
    ("Cumulative Land Uptake", "Gt C"),
    ("Effective Radiative Forcing|CO2", "W/m^2"),
]
FLAGSHIP_OUTPUTS = [name for name, _ in FLAGSHIP_VARIABLES[1:]] + ["Effective Radiative Forcing"]


def flagship_emissions(n_years):
    """bench.py's emissions ramp: slow growth, peak, decline (GtC / yr)."""
    return np.concatenate(
        [
            np.linspace(0.0, 2.0, 100),
            np.linspace(2.0, 12.0, 165),
            np.linspace(12.0, 4.0, 86),
            np.full(max(0, n_years - 351), 4.0),
        ]
    )[:n_years]


def build_flagship(pkg, years):
    """The two-layer + carbon-cycle flagship graph of ``bench.py:123-180``
    (CarbonCycle, CO2ERF and TwoLayer with the ``Effective Radiative
    Forcing`` Sum aggregate, driven by bench.py's emissions ramp) on
    ``years``, built with package ``pkg``."""
    core = importlib.import_module(f"{pkg}.core")
    components = importlib.import_module(f"{pkg}.components")
    years = np.asarray(years, dtype=np.float64)
    schema = core.VariableSchema()
    for name, unit in FLAGSHIP_VARIABLES:
        schema.add_variable(name, unit)
    schema.add_aggregate(
        "Effective Radiative Forcing", "W/m^2", "Sum", ["Effective Radiative Forcing|CO2"]
    )
    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_schema(schema)
        .with_component(components.CarbonCycle(tau=30.0, conc_pi=278.0, alpha_temperature=0.03))
        .with_component(components.CO2ERF(erf_2xco2=3.93, conc_pi=278.0))
        .with_component(
            components.TwoLayer(
                lambda0=1.1, a=0.0, efficacy=1.3, eta=0.8,
                heat_capacity_surface=8.0, heat_capacity_deep=110.0,
            )
        )
        .with_exogenous_variable(
            "Emissions|CO2|Anthropogenic",
            core.Timeseries.from_values(flagship_emissions(len(years)), years),
        )
        .with_initial_values(
            {
                "Surface Temperature": 0.0,
                "Deep Ocean Temperature": 0.0,
                "Atmospheric Concentration|CO2": 278.0,
                "Cumulative Emissions|CO2": 0.0,
                "Cumulative Land Uptake": 0.0,
            }
        )
        .build()
    )


def flagship_sweep(n, seed=42):
    """bench.py's four-parameter sweep (``bench.py:189-197``)."""
    rng = np.random.default_rng(seed)
    return {
        "TwoLayer.lambda0": rng.uniform(0.8, 1.8, n),
        "TwoLayer.eta": rng.uniform(0.5, 1.2, n),
        "CarbonCycle.tau": rng.uniform(15.0, 60.0, n),
        "CO2ERF.erf_2xco2": rng.uniform(3.0, 4.5, n),
    }


#: the TwoLayer toy of ``tests/test_nuts.py:26-70``
TOY_YEARS = np.arange(2000.0, 2051.0)
TOY_LAMBDA, TOY_ETA = 1.2, 0.7


def build_two_layer_toy(pkg, years=TOY_YEARS, lambda0=TOY_LAMBDA, eta=TOY_ETA):
    """The one-component TwoLayer model of ``tests/test_nuts.py::_build``
    on ``years``, built with package ``pkg``."""
    core = importlib.import_module(f"{pkg}.core")
    components = importlib.import_module(f"{pkg}.components")
    years = np.asarray(years, dtype=np.float64)
    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_component(
            components.TwoLayer(
                lambda0=lambda0, a=0.0, efficacy=1.0, eta=eta,
                heat_capacity_surface=8.0, heat_capacity_deep=100.0,
            )
        )
        .with_exogenous_variable(
            "Effective Radiative Forcing",
            core.Timeseries.from_values(np.full(len(years), 3.7), years),
        )
        .with_initial_values({"Surface Temperature": 0.0, "Deep Ocean Temperature": 0.0})
        .build()
    )


def toy_target(pkg, years=TOY_YEARS, noise_seed=1, sigma=0.05):
    """``tests/test_nuts.py::_make_target``: the truth run's temperature
    every five years from the tenth, with N(0, 0.02) noise."""
    calibrate = importlib.import_module(f"{pkg}.calibrate")
    truth = build_two_layer_toy("rscm_tpu_torch", years)
    truth.run(device="cpu")
    temps = truth.collection.get_data("Surface Temperature").values()[:, 0]
    rng = np.random.default_rng(noise_seed)
    target = calibrate.Target()
    vt = target.add_variable("Surface Temperature")
    for i in range(10, len(years), 5):
        vt.add(float(years[i]), float(temps[i] + rng.normal(0, 0.02)), sigma)
    return target


def toy_problem(pkg, names=("lambda0",), years=TOY_YEARS, device="cpu"):
    """``(params, runner, likelihood, target)`` of the toy calibration over
    ``names`` (``lambda0`` on U(0.5, 2.5), ``eta`` on U(0.3, 1.5)), built
    with package ``pkg`` (the port's runner on ``device``)."""
    calibrate = importlib.import_module(f"{pkg}.calibrate")
    priors = {"lambda0": (0.5, 2.5), "eta": (0.3, 1.5)}
    params = calibrate.ParameterSet()
    for name in names:
        params.add(name, calibrate.Uniform(*priors[name]))
    kwargs = {"device": device} if pkg == "rscm_tpu_torch" else {}
    runner = calibrate.CompiledModelRunner(
        build_two_layer_toy(pkg, years),
        param_map={name: f"TwoLayer.{name}" for name in names},
        output_variables=["Surface Temperature"],
        **kwargs,
    )
    return params, runner, calibrate.GaussianLikelihood(), toy_target(pkg, years)
