"""The host-path methods of ClimateUDEB and OceanCarbon against ``rscm_tpu``.

Each of the eleven methods of the JAX package's host path
(``rscm_tpu/magicc/climate/udeb.py:355-532``, ``magicc/carbon/ocean.py:255``,
``:423``) runs in both packages on the same seeded numpy inputs and must
agree at 1e-12; the port's methods take and return host values and mutate
``state`` where the reference does.  Also here: the reference's host-path
cases of ``tests/test_magicc_components.py:240-406`` (delta-DIC
convolution, uptake under elevated CO2, positive forcing warms, SST->air
amplification, upwelling slowdown), and the wraps of the batched solve
(the SST->air map, heat uptake, ocean heat content, the ring solve behind
``solve_ocean``) against that solve at one member.
"""

import copy

import numpy as np
import pytest
import torch

import rscm_tpu.magicc as jm
import rscm_tpu_torch.magicc as tm
from rscm_tpu_torch.core.spatial import FourBoxRegion
from test_torch_support import build_udeb, step_erf, values

TOL = dict(rtol=1e-12, atol=0.0)

#: ClimateUDEB parameter sets: the defaults, a shallow column with both
#: efficacy branches, and a zero SST->air curvature
UDEB_CASES = {
    "default": {},
    "n17_efficacy1": {"n_layers": 17, "efficacy_apply": 1, "prescribed_efficacy_co2": 1.2,
                      "ecs": 2.2, "kappa": 1.1},
    "efficacy2_no_land_heat": {"efficacy_apply": 2, "prescribed_efficacy_co2": 0.9,
                               "land_heat_capacity_enabled": False, "ecs": 4.5},
    "gamma0": {"temp_adjust_gamma": 0.0, "n_layers": 5},
}


def pair(case):
    return jm.ClimateUDEB(**UDEB_CASES[case]), tm.ClimateUDEB(**UDEB_CASES[case])


def seeded_state(comp, seed, history_years=320):
    """A host state with warm, perturbed columns, a stepped history and
    slowed upwelling (the same values whichever package made ``comp``)."""
    rng = np.random.default_rng(seed)
    state = comp.create_initial_state()
    n = comp.n_layers
    state["ocean_temps"][:] = state["initial_ocean_profile"] * 0.05 + rng.uniform(0.0, 1.5, (2, n))
    state["land_temps"][:] = rng.uniform(0.2, 2.0, 2)
    state["ground_temps"][:] = rng.uniform(0.1, 1.5, 2)
    state["upwelling_rates"][:] = rng.uniform(1.2, 3.4, 2)
    state["hemi_heat_exchange"][:] = rng.uniform(-0.3, 0.3, 2)
    k = min(history_years, len(state["th_dts"]))
    state["th_values"][:k] = rng.uniform(0.0, 2.0, k)
    state["th_dts"][:k] = 1.0
    return state


def assert_states_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], dtype=float),
                                   np.asarray(want[key], dtype=float), err_msg=key, **TOL)


# ---------------------------------------------------------------------------
# the eleven methods against rscm_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(UDEB_CASES))
def test_apply_efficacy_and_qfrac(case):
    ref, port = pair(case)
    for erf, eff in ((2.3, 1.1), (-0.7, 0.8), (1.0, float("nan")), (3.7, -1.0)):
        got = port.apply_efficacy_and_qfrac(erf, eff)
        assert isinstance(got, np.ndarray) and got.shape == (4,)
        np.testing.assert_allclose(got, ref.apply_efficacy_and_qfrac(erf, eff), **TOL)


@pytest.mark.parametrize("case", sorted(UDEB_CASES))
@pytest.mark.parametrize("history_years", [0, 120, 320, 512])
def test_adjusted_ecs(case, history_years):
    ref, port = pair(case)
    state = seeded_state(ref, 3, history_years)
    # a partial step inside the feedback period: the walk weights it
    state["th_dts"][: min(history_years, 7)] = 0.7
    for forcing in (-1.0, 0.0, 2.5, 7.4):
        got = port.adjusted_ecs(forcing, copy.deepcopy(state))
        assert isinstance(got, float)
        np.testing.assert_allclose(got, ref.adjusted_ecs(forcing, copy.deepcopy(state)), **TOL)


@pytest.mark.parametrize("case", sorted(UDEB_CASES))
def test_calculate_land_temperature(case):
    ref, port = pair(case)
    rng = np.random.default_rng(4)
    for ocean, forcing, frac, lam in rng.uniform((-2, -1, 0.05, 0.5), (40, 8, 0.5, 2.5), (8, 4)):
        np.testing.assert_allclose(
            port.calculate_land_temperature(ocean, forcing, frac, lam),
            ref.calculate_land_temperature(ocean, forcing, frac, lam), **TOL)


@pytest.mark.parametrize("case", sorted(UDEB_CASES))
def test_sst_to_air_temperature(case):
    ref, port = pair(case)
    # both sides of t* = (alpha - 1) / (-2 gamma) = 10 K at the defaults
    for sst in (-3.0, 0.0, 1e-16, 0.4, 5.0, 9.999, 10.0, 10.5, 30.0):
        got = port.sst_to_air_temperature(sst)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, ref.sst_to_air_temperature(sst), rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("case", sorted(UDEB_CASES))
@pytest.mark.parametrize("hemi", [0, 1])
def test_layer_diffusivities(case, hemi):
    ref, port = pair(case)
    state = seeded_state(ref, 5)
    state["ocean_temps"][hemi, -1] = state["ocean_temps"][hemi, 0] + 30.0  # kappa_min clips
    np.testing.assert_allclose(port.layer_diffusivities(state, hemi),
                               ref.layer_diffusivities(state, hemi), **TOL)


@pytest.mark.parametrize("case", sorted(UDEB_CASES))
@pytest.mark.parametrize("hemi", [0, 1])
def test_step_hemisphere(case, hemi):
    ref, port = pair(case)
    state = seeded_state(ref, 6 + hemi)
    mine, theirs = copy.deepcopy(state), copy.deepcopy(state)
    for month in range(3):  # upwelling away from w_initial: the delta-w terms
        args = (hemi, 2.9 + 0.1 * month, 1.0 / 12.0, ref.lambda_ocean, ref.lambda_land,
                0.15, 0.4, ref.temp_adjust_alpha)
        got = port.step_hemisphere(mine, *args)
        want = ref.step_hemisphere(theirs, *args)
        np.testing.assert_allclose(got, want, **TOL)
    assert_states_equal(mine, theirs)
    assert not np.array_equal(mine["ocean_temps"][hemi], state["ocean_temps"][hemi])
    np.testing.assert_array_equal(mine["ocean_temps"][1 - hemi], state["ocean_temps"][1 - hemi])


@pytest.mark.parametrize("case", sorted(UDEB_CASES))
def test_update_upwelling(case):
    ref, port = pair(case)
    for temp in (-1.0, 0.0, 3.3, 8.0, 12.0):
        mine, theirs = ref.create_initial_state(), ref.create_initial_state()
        assert port.update_upwelling(mine, temp) is None
        ref.update_upwelling(theirs, temp)
        np.testing.assert_allclose(mine["upwelling_rates"], theirs["upwelling_rates"], **TOL)


@pytest.mark.parametrize("case", sorted(UDEB_CASES))
def test_calculate_heat_uptake(case):
    ref, port = pair(case)
    rng = np.random.default_rng(8)
    for _ in range(4):
        forcing = rng.uniform(-1.0, 6.0, 4)
        temperature = rng.uniform(-0.5, 4.0, 4)
        lam_o, lam_l = rng.uniform(0.5, 2.5, 2)
        got = port.calculate_heat_uptake(forcing, temperature, lam_o, lam_l)
        want = ref.calculate_heat_uptake(forcing, temperature, lam_o, lam_l)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14 * np.abs(forcing).max())


@pytest.mark.parametrize("case", sorted(UDEB_CASES))
def test_calculate_ocean_heat_content(case):
    ref, port = pair(case)
    state = seeded_state(ref, 9)
    got = port.calculate_ocean_heat_content(state)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, ref.calculate_ocean_heat_content(state), **TOL)


def ocean_pair(**params):
    return (jm.OceanCarbon.from_parameters(params), tm.OceanCarbon.from_parameters(params))


def realistic_history(n_months, seed):
    """A newest-first flux history (ppm a month) of the size a century of
    uptake leaves: small, positive, rising toward the present."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.02, 0.0, n_months)
    return ramp * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, n_months))


@pytest.mark.parametrize("model", ["3D-GFDL", "2D-BERN", "HILDA"])
@pytest.mark.parametrize("n_months", [0, 12, 100, 6000])
def test_calculate_delta_dic(model, n_months):
    ref, port = ocean_pair(model=model, max_history_months=6000)
    history = realistic_history(n_months, 10)
    got = port.calculate_delta_dic(history)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, float(ref.calculate_delta_dic(history)), **TOL)


@pytest.mark.parametrize("model", ["3D-GFDL", "2D-BERN", "HILDA"])
@pytest.mark.parametrize("n_months,window", [(600, 600), (240, 600), (5, 600), (6000, 6000)])
def test_solve_ocean(model, n_months, window):
    """Five years chained through ``solve_ocean``, newest-first history in
    and out, with the temperature feedback on and a rising CO2."""
    ref, port = ocean_pair(model=model, max_history_months=window, engine="ring")
    mine = theirs = realistic_history(n_months, 11)
    pco2, cum = ref.pco2_pi, 0.0
    got_pco2, got_cum = pco2, cum
    for year in range(5):
        co2, sst = 300.0 + 12.0 * year, 0.05 * year
        mine, got_pco2, got_cum, got_flux = port.solve_ocean(mine, co2, sst, got_pco2, got_cum, 1.0)
        theirs, pco2, cum, flux = ref.solve_ocean(theirs, co2, sst, pco2, cum, 1.0)
        assert isinstance(mine, np.ndarray) and mine.dtype == np.float64
        assert mine.shape == np.shape(theirs)
        np.testing.assert_allclose(mine, theirs, rtol=1e-12, atol=1e-14 * np.abs(theirs).max())
        for got, want in ((got_pco2, pco2), (got_cum, cum), (got_flux, flux)):
            assert isinstance(got, float)
            np.testing.assert_allclose(got, float(want), **TOL)


def test_solve_ocean_refuses_a_history_longer_than_the_window():
    _, port = ocean_pair(max_history_months=120, engine="ring")
    with pytest.raises(ValueError, match="window"):
        port.solve_ocean(np.zeros(121), 400.0, 0.0, port.pco2_pi, 0.0, 1.0)


# ---------------------------------------------------------------------------
# the reference's host-path cases (tests/test_magicc_components.py:240-406)
# ---------------------------------------------------------------------------


def test_delta_dic_convolution():
    c = tm.OceanCarbon()
    empty = np.zeros(c.max_history_months)
    assert c.calculate_delta_dic(empty) == 0.0
    one_year = empty.copy()
    one_year[:12] = 1.0
    five_years = empty.copy()
    five_years[:60] = 1.0
    assert 0.0 < c.calculate_delta_dic(one_year) < c.calculate_delta_dic(five_years)


def test_uptake_under_elevated_co2():
    c = tm.OceanCarbon(engine="ring")
    state = c.create_initial_state()
    flux_history, pco2, cumulative, flux = c.solve_ocean(
        state["flux_history"], 400.0, 0.0, c.pco2_pi, 0.0, 1.0
    )
    assert flux > 0.0
    assert cumulative > 0.0
    assert pco2 > c.pco2_pi  # ocean pCO2 rises as DIC accumulates
    assert flux_history.shape == state["flux_history"].shape
    assert np.all(flux_history[:12] > 0.0) and np.all(flux_history[12:] == 0.0)


def test_positive_forcing_warms():
    c = tm.ClimateUDEB()
    state = c.create_initial_state()
    new_temp = c.step_hemisphere(
        state, 0, 3.71, 1.0 / 12.0, c.lambda_ocean, c.lambda_land, 0.0, 0.0,
        c.temp_adjust_alpha,
    )
    assert new_temp > 0.0


def test_sst_to_air_amplification():
    c = tm.ClimateUDEB()
    assert abs(c.sst_to_air_temperature(0.0)) < 1e-10
    t1 = c.sst_to_air_temperature(1.0)
    t5 = c.sst_to_air_temperature(5.0)
    assert t1 > 1.0
    assert t5 / 5.0 < t1 / 1.0  # amplification decreases


def test_upwelling_slowdown():
    c = tm.ClimateUDEB()
    state = c.create_initial_state()
    w0 = state["upwelling_rates"][0]
    c.update_upwelling(state, 4.0)
    assert state["upwelling_rates"][0] < w0
    c.update_upwelling(state, 10.0)
    w_min = c.w_initial * (1.0 - c.w_variable_fraction)
    assert state["upwelling_rates"][0] == pytest.approx(w_min)


# ---------------------------------------------------------------------------
# the wraps against the batched solve at one member
# ---------------------------------------------------------------------------


def udeb_node(model):
    return next(n for n in model.exec_order
                if type(model.graph.nodes[n]).__name__ == "ClimateUDEB")


@pytest.mark.parametrize("case", ["default", "n17_efficacy1", "efficacy2_no_land_heat"])
def test_wraps_match_the_batched_solve_at_one_member(case):
    """Step a one-member ClimateUDEB model on the CPU; after the last step,
    the host pieces evaluated on the host state give the step's own
    outputs: the ocean heat content, the SST->air map of both columns, and
    the heat uptake from the lambdas LAMCALC gives for the adjusted ECS."""
    years = np.arange(1850.0, 1857.0)
    erf = step_erf(years, level=4.0, step_year=1851.0)
    model = build_udeb("rscm_tpu_torch", years, erf, **UDEB_CASES[case])
    comp = model.graph.nodes[udeb_node(model)]
    for _ in range(len(years) - 2):
        model.step(device="cpu")
    before = copy.deepcopy(model.component_states[udeb_node(model)])
    model.step(device="cpu")
    state = model.component_states[udeb_node(model)]
    last = len(years) - 1

    np.testing.assert_allclose(comp.calculate_ocean_heat_content(state),
                               values(model, "Ocean Heat Content")[last, 0], **TOL)
    surface = values(model, "Surface Temperature")[last]
    fourbox = [FourBoxRegion.NorthernOcean, FourBoxRegion.SouthernOcean]
    for hemi, region in enumerate(fourbox):
        np.testing.assert_allclose(comp.sst_to_air_temperature(state["ocean_temps"][hemi][0]),
                                   surface[int(region)], **TOL)

    erf_start, erf_end = erf[last - 1], erf[last]
    adjusted = comp.adjusted_ecs((erf_start + erf_end) / 2.0, before)
    lam = comp._run_lamcalc(adjusted)
    forcing_end = comp.apply_efficacy_and_qfrac(erf_end, lam.co2_internal_efficacy)
    np.testing.assert_allclose(
        comp.calculate_heat_uptake(forcing_end, surface, lam.lambda_ocean, lam.lambda_land),
        values(model, "Heat Uptake")[last, 0], rtol=1e-10, atol=0.0)


@pytest.mark.parametrize("step_index", [0, 7, 499])
def test_solve_ocean_matches_the_ring_solve_at_one_member(step_index):
    """``solve_ocean`` enters the ring at step 0; the year loop's ring at
    any other step holds the same history rotated, and its year gives the
    same values."""
    ocean = tm.OceanCarbon(engine="ring", max_history_months=600)
    history = realistic_history(600, 12)
    new_history, pco2, cum, flux = ocean.solve_ocean(history, 410.0, 0.3, 285.0, 3.0, 1.0)

    ring = ocean._to_loop_layout({"flux_history": torch.as_tensor(history)[None]}, step_index)
    member = lambda v: torch.tensor([v], dtype=torch.float64)  # noqa: E731
    ring, r_pco2, r_cum, r_flux = ocean._solve_ocean_circular(
        ring["flux_history"], member(410.0), member(0.3), member(285.0), member(3.0), 1.0,
        step_index)
    back = ocean._to_host_layout({"flux_history": ring}, step_index + 1)["flux_history"][0]
    np.testing.assert_array_equal(new_history, back.numpy())
    assert (pco2, cum, flux) == (float(r_pco2[0]), float(r_cum[0]), float(r_flux[0]))


@pytest.mark.parametrize("model", ["3D-GFDL", "HILDA"])
def test_solve_ocean_pco2_follows_its_history(model):
    """The last month's pCO2 is the carbonate chemistry of the DIC the
    returned history implies: ``calculate_delta_dic`` convolves the same
    IRF over the same ages the year's last month saw."""
    ocean = tm.OceanCarbon.from_parameters({"model": model, "engine": "ring"})
    history = realistic_history(ocean.max_history_months, 13)
    new_history, pco2, _, _ = ocean.solve_ocean(history, 420.0, 0.7, 300.0, 0.0, 1.0)
    implied = ocean.ocean_pco2_value(
        ocean.delta_pco2_from_dic(ocean.calculate_delta_dic(new_history)), 0.7)
    np.testing.assert_allclose(pco2, float(implied), rtol=1e-12)
