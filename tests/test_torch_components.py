"""The generic component library, the RK4 solver and HalocarbonChemistry
through ``rscm_tpu_torch`` against ``rscm_tpu`` on the CPU in float64.

- ``substep_count`` gives the reference's counts and raises where it does
  (a count that varies over the axis; a landing time off by more than
  ``T_THRESHOLD``);
- ``rk4_integrate`` on host floats and on tensors (the reference on host
  floats and on jax arrays, where it rolls the sub-steps into a
  ``fori_loop``) at rtol 1e-15: the same operations in the same order;
- each of the five components' ``solve_ctx`` at B = 4 with seeded random
  parameters and inputs: the port solves the four members at once on
  ``(n_steps, B, regions)`` tensors, the reference each member on its host
  path; rtol 1e-12;
- ``HalocarbonChemistry`` the same way, and through both packages' year
  loops and step-by-step executors over 30 years.
"""

import numpy as np
import pytest
import torch

import rscm_tpu.components as jax_components
import rscm_tpu.core.ivp as jax_ivp
import rscm_tpu_torch.components as port_components
import rscm_tpu_torch.core.ivp as port_ivp
from rscm_tpu.core.component import SolveContext as JaxSolveContext
from rscm_tpu.core.model.input_state import InputState as JaxInputState
from rscm_tpu.core.model.runtime import prepare_inputs as jax_prepare
from rscm_tpu.core.state import StateValue as JaxStateValue, make_window as jax_window
from rscm_tpu.magicc import HalocarbonChemistry as JaxHalocarbon
from rscm_tpu_torch.core.component import SolveContext
from rscm_tpu_torch.core.model.input_state import InputState
from rscm_tpu_torch.core.model.runtime import prepare_inputs
from rscm_tpu_torch.core.state import StateValue, make_window
from rscm_tpu_torch.magicc import HalocarbonChemistry
from test_torch_support import build_single, values

B = 4
YEARS = np.arange(2000.0, 2011.0)
IDX = 6
TOL = dict(rtol=1e-12, atol=1e-12)


# -- substep_count and rk4 ------------------------------------------------------


class _Ctx:
    def __init__(self, t0, t1, spans=None):
        self.t_current, self.t_next, self.spans = t0, t1, spans


@pytest.mark.parametrize(
    "ctx, step",
    [
        (_Ctx(2000.0, 2001.0), 0.1),
        (_Ctx(2000.0, 2001.0), 0.25),
        (_Ctx(2000.0, 2005.0), 0.1),
        (_Ctx(0.0, 1.0, spans=np.full(20, 1.0)), 0.1),
        (_Ctx(0.0, 1.0 / 12.0, spans=np.full(24, 1.0 / 12.0)), 1.0 / 120.0),
    ],
    ids=["annual", "quarter", "five_years", "axis_spans", "monthly"],
)
def test_substep_count_matches_jax(ctx, step):
    assert port_ivp.T_THRESHOLD == jax_ivp.T_THRESHOLD
    assert port_ivp.substep_count(ctx, step) == jax_ivp.substep_count(ctx, step)


def test_substep_count_raises_where_jax_does():
    varying = _Ctx(0.0, 1.0, spans=np.array([1.0, 1.0, 2.0]))
    for ivp in (jax_ivp, port_ivp):
        with pytest.raises(ValueError, match="varies across the time axis"):
            ivp.substep_count(varying, 0.1)
    # ceil(1 / 0.3) = 4 sub-steps land at 1.2: 0.2 past the step end
    off = _Ctx(2000.0, 2001.0)
    for ivp in (jax_ivp, port_ivp):
        with pytest.raises(AssertionError, match="T_THRESHOLD|misses the step end"):
            ivp.substep_count(off, 0.3)
    # within the threshold: ten 0.1 sub-steps over 0.998 land 2e-3 late
    near = _Ctx(2000.0, 2000.998)
    assert port_ivp.substep_count(near, 0.1) == jax_ivp.substep_count(near, 0.1) == 10


def _decay_oscillator(xm):
    def f(t, y):
        a, b, c = y
        return (-0.3 * a + 0.5 * b * xm.exp(-0.01 * t), -a * 0.8 - 0.05 * b, a * a - c / (1.0 + t))

    return f


def test_rk4_integrate_host_floats_match_jax():
    import rscm_tpu.core.xmath as jax_xm
    import rscm_tpu_torch.core.xmath as port_xm

    y0 = (1.0, -0.5, 0.25)
    want = jax_ivp.rk4_integrate(_decay_oscillator(jax_xm), y0, 3.0, 0.1, 10)
    got = port_ivp.rk4_integrate(_decay_oscillator(port_xm), y0, 3.0, 0.1, 10)
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               rtol=1e-15, atol=0.0)


def test_rk4_integrate_tensors_match_jax_arrays():
    import jax.numpy as jnp

    import rscm_tpu.core.xmath as jax_xm
    import rscm_tpu_torch.core.xmath as port_xm

    rng = np.random.default_rng(7)
    y0 = [rng.uniform(-1.0, 1.0, B) for _ in range(3)]
    want = jax_ivp.rk4_integrate(
        _decay_oscillator(jax_xm), tuple(jnp.asarray(v) for v in y0), 3.0, 0.1, 10
    )
    got = port_ivp.rk4_integrate(
        _decay_oscillator(port_xm), tuple(torch.tensor(v) for v in y0), 3.0, 0.1, 10
    )
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.shape == (B,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15, atol=1e-16)


# -- one solve at B members against the reference per member -----------------


def _series(rng, lo, hi, grid_size):
    """``(n_steps, B, grid_size)`` seeded inputs between lo and hi."""
    return rng.uniform(lo, hi, (len(YEARS), B, grid_size))


def port_solve(component, params, inputs):
    """One ``solve_ctx`` of ``component`` with per-member ``params`` for all
    B members on tensors, as the year loop calls it; outputs as ``(B, g)``."""
    grids = {d.name: d.grid_type for d in component.inputs()}
    builders = {
        name: (lambda name=name, v=v: make_window(
            grids[name], torch.tensor(v), IDX, YEARS[IDX], time_values=YEARS))
        for name, v in inputs.items()
    }
    bound = component.with_params({k: torch.tensor(v) for k, v in params.items()})
    ctx = SolveContext(YEARS[IDX], YEARS[IDX + 1], IDX, spans=np.diff(YEARS), scan_mode=True)
    outputs, _ = bound.solve_ctx(ctx, prepare_inputs(bound, InputState(builders, YEARS[IDX])),
                                 bound.create_initial_state())
    if hasattr(outputs, "to_dict"):
        outputs = outputs.to_dict()
    out = {}
    for name, value in outputs.items():
        row = StateValue.wrap(value).as_array()
        out[name] = torch.as_tensor(row).expand(B, row.shape[-1]).numpy()
    return out


def jax_solve(component, params, inputs):
    """The reference's host solve, one member at a time; ``(B, g)``."""
    grids = {d.name: d.grid_type for d in component.inputs()}
    rows = []
    for m in range(B):
        builders = {
            name: (lambda name=name, v=v: jax_window(
                grids[name], np.asarray(v[:, m]), IDX, YEARS[IDX], time_values=YEARS))
            for name, v in inputs.items()
        }
        member = component.with_params({k: float(v[m]) for k, v in params.items()})
        ctx = JaxSolveContext(YEARS[IDX], YEARS[IDX + 1], IDX)
        outputs, _ = member.solve_ctx(
            ctx, jax_prepare(member, JaxInputState(builders, YEARS[IDX])),
            member.create_initial_state(),
        )
        if hasattr(outputs, "to_dict"):
            outputs = outputs.to_dict()
        rows.append({k: np.asarray(JaxStateValue.wrap(v).as_array(), dtype=float)
                     for k, v in outputs.items()})
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _random_case(name, seed):
    """(component kwargs, per-member params, inputs) of one component."""
    rng = np.random.default_rng(seed)

    def u(lo, hi):
        return rng.uniform(lo, hi, B)

    if name == "TwoLayer":
        kwargs = dict(lambda0=1.0, a=0.0, efficacy=1.0, eta=0.7,
                      heat_capacity_surface=8.0, heat_capacity_deep=100.0)
        params = dict(lambda0=u(0.8, 1.8), a=u(0.0, 0.05), efficacy=u(0.8, 1.5),
                      eta=u(0.5, 1.2), heat_capacity_surface=u(6.0, 10.0),
                      heat_capacity_deep=u(80.0, 120.0))
        inputs = {"Effective Radiative Forcing": _series(rng, 0.0, 5.0, 1),
                  "Surface Temperature": _series(rng, 0.0, 2.0, 1),
                  "Deep Ocean Temperature": _series(rng, 0.0, 0.5, 1)}
    elif name == "CarbonCycle":
        kwargs = dict(tau=30.0, conc_pi=278.0, alpha_temperature=0.03)
        params = dict(tau=u(15.0, 60.0), conc_pi=u(270.0, 290.0),
                      alpha_temperature=u(0.0, 0.05))
        inputs = {"Emissions|CO2|Anthropogenic": _series(rng, 0.0, 12.0, 1),
                  "Surface Temperature": _series(rng, 0.0, 2.0, 1),
                  "Atmospheric Concentration|CO2": _series(rng, 280.0, 450.0, 1),
                  "Cumulative Emissions|CO2": _series(rng, 0.0, 500.0, 1),
                  "Cumulative Land Uptake": _series(rng, 0.0, 200.0, 1)}
    elif name == "CO2ERF":
        kwargs = dict(erf_2xco2=3.93, conc_pi=278.0)
        params = dict(erf_2xco2=u(3.0, 4.5), conc_pi=u(270.0, 290.0))
        inputs = {"Atmospheric Concentration|CO2": _series(rng, 280.0, 600.0, 1)}
    elif name == "FourBoxOceanHeatUptake":
        kwargs = {}
        ratios = rng.uniform(0.5, 1.5, (4, B))
        ratios = ratios / ratios.mean(axis=0)  # each member's ratios average 1
        params = dict(zip(("northern_ocean_ratio", "northern_land_ratio",
                           "southern_ocean_ratio", "southern_land_ratio"), ratios))
        inputs = {"Effective Radiative Forcing|Aggregated": _series(rng, -1.0, 5.0, 1)}
    else:
        from rscm_tpu_torch.magicc.carbon.ocean import (
            DELTA_OSPP_COEFFICIENTS, DELTA_OSPP_OFFSETS,
        )

        kwargs = dict(ospp_preindustrial=278.0, sensitivity_ospp_to_temperature=0.0423,
                      delta_ospp_offsets=DELTA_OSPP_OFFSETS,
                      delta_ospp_coefficients=DELTA_OSPP_COEFFICIENTS)
        params = dict(ospp_preindustrial=u(270.0, 290.0),
                      sensitivity_ospp_to_temperature=u(0.02, 0.05),
                      sea_surface_temperature_preindustrial=u(15.0, 19.0))
        inputs = {"Sea Surface Temperature": _series(rng, 0.0, 3.0, 1),
                  "Dissolved Inorganic Carbon": _series(rng, 0.0, 60.0, 1)}
    return kwargs, params, inputs


COMPONENTS = ["TwoLayer", "CarbonCycle", "CO2ERF", "FourBoxOceanHeatUptake",
              "OceanSurfacePartialPressure"]


@pytest.mark.parametrize("name", COMPONENTS)
def test_component_solve_matches_jax_per_member(name):
    kwargs, params, inputs = _random_case(name, seed=COMPONENTS.index(name) + 11)
    port = getattr(port_components, name)(**kwargs)
    ref = getattr(jax_components, name)(**kwargs)
    got = port_solve(port, params, inputs)
    want = jax_solve(ref, params, inputs)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert np.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


def test_components_export_the_reference_names():
    assert sorted(port_components.__all__) == sorted(jax_components.__all__)
    assert port_components.GTC_PER_PPM == jax_components.GTC_PER_PPM
    for name in COMPONENTS:
        builder = getattr(port_components, f"{name}Builder")
        kwargs, _, _ = _random_case(name, seed=0)
        built = builder.from_parameters(kwargs).build()
        assert type(built) is getattr(port_components, name)


def test_four_box_ratios_must_average_one():
    with pytest.raises(AssertionError, match="average to 1.0"):
        port_components.FourBoxOceanHeatUptake.from_parameters(
            {"northern_ocean_ratio": 2.0})
    with pytest.raises(AssertionError, match="average to 1.0"):
        jax_components.FourBoxOceanHeatUptake.from_parameters({"northern_ocean_ratio": 2.0})


def test_example_component_is_not_registered():
    from rscm_tpu_torch.core.component import Component
    from rscm_tpu_torch.core.example_components import TestComponent, TestComponentBuilder

    assert "TestComponent" not in Component.get_registered_components()
    comp = TestComponentBuilder.from_parameters({"conversion_factor": 0.5}).build()
    assert comp.calculate_concentration(4.0) == 2.0
    with pytest.raises(ValueError, match="missing field `conversion_factor`"):
        TestComponentBuilder.from_parameters({})
    for name in ("TwoLayer", "CarbonCycle", "CO2ERF", "FourBoxOceanHeatUptake",
                 "OceanSurfacePartialPressure", "HalocarbonChemistry"):
        assert Component.get_component(name).__name__ == name


# -- HalocarbonChemistry ----------------------------------------------------------


def _halocarbon_inputs(component, rng):
    inputs = {}
    for sp in component.species:
        inputs[component.concentration_name(sp.name)] = _series(rng, 0.0, 600.0, 1)
        inputs[component.emissions_name(sp.name)] = _series(rng, 0.0, 30.0, 1)
    return inputs


def test_halocarbon_solve_matches_jax_per_member():
    rng = np.random.default_rng(21)
    port, ref = HalocarbonChemistry(), JaxHalocarbon()
    params = dict(br_multiplier=rng.uniform(45.0, 65.0, B),
                  cfc11_release_normalisation=rng.uniform(0.4, 0.5, B),
                  air_molar_mass=rng.uniform(28.5, 29.5, B),
                  mixing_box_fraction=rng.uniform(0.9, 0.99, B))
    inputs = _halocarbon_inputs(port, rng)
    got = port_solve(port, params, inputs)
    want = jax_solve(ref, params, inputs)
    assert set(got) == set(want) and len(want) == len(port.species) + 4
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


def _halocarbon_model(pkg, years):
    magicc = __import__(f"{pkg}.magicc", fromlist=["HalocarbonChemistry"])
    comp = magicc.HalocarbonChemistry()
    rng = np.random.default_rng(22)
    exogenous = {
        comp.emissions_name(sp.name): (rng.uniform(0.0, 30.0, len(years)), "kt/yr")
        for sp in comp.species
    }
    initial = {comp.concentration_name(sp.name): sp.concentration_pi for sp in comp.species}
    return build_single(pkg, comp, years, exogenous, initial)


@pytest.mark.parametrize("compiled", [True, False], ids=["year_loop", "step_by_step"])
def test_halocarbon_model_matches_jax(compiled):
    years = np.arange(1950.0, 1980.0)
    ref = _halocarbon_model("rscm_tpu", years)
    ref.run(compiled=compiled)
    port = _halocarbon_model("rscm_tpu_torch", years)
    port.run(compiled=compiled, device="cpu")
    names = ["Forcing|Halocarbons", "Forcing|F-gases", "Forcing|Montreal Gases", "EESC",
             "Atmospheric Concentration|CFC-11", "Atmospheric Concentration|SF6"]
    for name in names:
        got = values(port, name)
        assert np.isfinite(got[1:]).all(), name
        np.testing.assert_allclose(got, values(ref, name), err_msg=name, **TOL)
