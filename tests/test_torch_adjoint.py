"""The adjoint twins of both kernels against the JAX package's derivative rule.

On CUDA tensors the port's ``UdebYearFunction`` and ``LamcalcFunction`` take
their derivatives from hand-written tangent and adjoint kernels; each
adjoint kernel has an explicit plain PyTorch twin
(``udeb_month.udeb_year_vjp_plain``, ``lamcalc_kernel.lamcalc_vjp_plain``)
that performs its operations in its order, and ``chip_smoke.py`` holds the
kernels against the twins on the card.  Here, on the CPU, the twins are held
against ``jax.vjp`` of the JAX package's member functions under ``vmap``
(whose ``custom_jvp`` rule differentiates the kernels' ``jnp`` references)
and against torch autograd of the plain forwards, at 1e-12 in float64, over
the branches each adjoint has to reverse: the layer counts, land heat on and
off, the SST->air map's two sides and its linear form, the clamp at the
maximum temperature, the upwelling floor and a saturated warming ratio (a
tie, where ``maximum`` halves the cotangent), ``kappa``'s floor, a broadcast
and a per-member initial profile; LAMCALC with fallback members, members
that converge after different numbers of iterations, and a zero CO2 forcing
pattern.  On CPU tensors the Functions' ``backward`` is the twins.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from rscm_tpu.magicc import ClimateUDEB as JaxUDEB
from rscm_tpu.ops import lamcalc_kernel as jax_lamcalc
from rscm_tpu.ops import udeb_month as jax_udeb
from rscm_tpu_torch.magicc import ClimateUDEB
from rscm_tpu_torch.magicc.climate.lamcalc import LamcalcParams
from rscm_tpu_torch.ops import lamcalc_kernel, udeb_month
from test_torch_kernels import STALL_MEMBERS, lamcalc_setup, udeb_inputs

TOL = 1e-12
B = 6
ROW = {name: i for i, name in enumerate(udeb_month.SCALAR_ROWS)}
W_THRESH = (udeb_month.S, udeb_month.S + 1)


@functools.lru_cache(maxsize=None)
def jax_udeb_vjp(n_layers, land_heat, b):
    """``(inputs, cotangents) -> cotangents of the inputs`` by ``jax.vjp`` of
    the JAX package's member function (``custom_jvp`` around the Pallas
    call) under ``vmap``, on member-minor copies of the inputs; one compile
    per configuration."""
    comp = JaxUDEB(n_layers=n_layers, land_heat_capacity_enabled=land_heat)
    member = jax_udeb._get_member_fn(jax_udeb._static_from_component(comp), True)

    def fn(scal, ocean, init, vec):
        o, v = jax.vmap(member)(scal.T, ocean.T.reshape(b, 2, n_layers),
                                init.T.reshape(b, 2, n_layers), vec.T)
        return o.reshape(b, 2 * n_layers).T, v.T

    return jax.jit(lambda p, c: jax.vjp(fn, *p)[1](c))


def _straddle(scal, ocean, n):
    # the SST->air map's turning point t* = -(alpha - 1) / (2 gamma) = 2 K,
    # inside the surface temperatures' range (0-4 K)
    scal[ROW["adj_alpha"]] = 1.2
    scal[ROW["adj_gamma"]] = -0.05


def _gamma_zero(scal, ocean, n):
    scal[ROW["adj_gamma"], ::2] = 0.0  # the linear map alpha * sst


def _clamp(scal, ocean, n):
    scal[ROW["max_temp"]] = 2.0


def _upwelling_floor(scal, ocean, n):
    # even members: a negative variable fraction puts the floor above the
    # upwelling; odd members: a low threshold saturates the warming ratio
    # at 1, where the upwelling ties with its floor
    scal[ROW["w_var_frac"], ::2] = -0.3
    for row in W_THRESH:
        scal[row, 1::2] = 0.05


def _kappa_floor(scal, ocean, n):
    scal[ROW["kappa_min"]] = scal[ROW["kappa"]] * udeb_month.static_from_component(
        ClimateUDEB(n_layers=n), 1.0).diffusivity_scale


#: id -> (layers, land heat, input change, per-member initial profile)
UDEB_CASES = {
    "n2": (2, True, None, False),
    "n3": (3, True, None, False),
    "n3-no-land-heat": (3, False, None, True),
    "n3-gamma-zero": (3, True, _gamma_zero, False),
    "n3-sst-both-sides": (3, True, _straddle, False),
    "n3-clamp": (3, True, _clamp, False),
    "n17-upwelling-floor": (17, True, _upwelling_floor, False),
    "n17-kappa-floor": (17, True, _kappa_floor, False),
    "n17-per-member-profile": (17, True, None, True),
    "n50": (50, True, None, False),
}


def udeb_case(case, seed=3):
    n, land_heat, change, per_member = UDEB_CASES[case]
    comp = ClimateUDEB(n_layers=n, land_heat_capacity_enabled=land_heat)
    st = udeb_month.static_from_component(comp, 1.0)
    scal, ocean, init, vec = udeb_inputs(comp, seed, b=B)
    if change is not None:
        change(scal, ocean, n)
    if per_member:
        init = init + np.random.default_rng(seed).uniform(-0.2, 0.2, init.shape)
    return st, (scal, ocean, init, vec), per_member


def first_month_tape(st, scal, ocean, init, vec):
    tape = {}
    udeb_month._month_plain(st, scal, ocean.reshape(2, st.n, -1), vec[0:2], vec[2:4], vec[4:6],
                            vec[6:8], vec[8:10], init.reshape(2, st.n, -1), 1 / st.steps,
                            tape=tape)
    return tape


@pytest.mark.parametrize("case", list(UDEB_CASES))
def test_udeb_adjoint_twin_matches_jax_vjp_and_autograd(case):
    st, arrays, per_member = udeb_case(case)
    n = st.n
    rng = np.random.default_rng(7)
    cot = (rng.normal(size=(2 * n, B)), rng.normal(size=(8, B)))
    scal, ocean, init, vec = (torch.tensor(a) for a in arrays)
    if not per_member:  # the broadcast view the model passes
        init = init[:, :1].expand(2 * n, B)

    got = udeb_month.udeb_year_vjp_plain(st, scal, ocean, init, vec, *map(torch.tensor, cot))

    # the branch each case is there for
    out_ocean, out_vec = udeb_month.udeb_year_plain(st, scal, ocean, init, vec)
    tape = first_month_tape(st, scal, ocean, init, vec)
    sc = {name: scal[i] for i, name in enumerate(udeb_month.SCALAR_ROWS)}
    if case == "n3-sst-both-sides":
        sst = torch.minimum(tape["x"][0], sc["max_temp"])
        assert bool((sst < tape["t_star"]).any()) and bool((sst >= tape["t_star"]).any())
    if case == "n3-clamp":
        assert bool((out_ocean == sc["max_temp"]).any())
    if case == "n17-upwelling-floor":
        assert torch.equal(out_vec[6:8], (sc["w_initial"] * (1.0 - sc["w_var_frac"])).expand(2, B))
    if case == "n17-kappa-floor":
        below = tape["kappa_pre"] < sc["kappa_min"]
        assert bool(below.any()) and bool((~below).any())

    want_jax = jax_udeb_vjp(n, st.land_heat_enabled, B)(tuple(arrays), cot)
    xs = [x.detach().clone().requires_grad_(True) for x in (scal, ocean, init, vec)]
    want_torch = torch.autograd.grad(udeb_month.udeb_year_plain(st, *xs), xs,
                                     tuple(map(torch.tensor, cot)))
    for name, g, wj, wt in zip(("scal", "ocean", "init_prof", "vec"), got, want_jax, want_torch):
        assert g.shape == wt.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), rtol=TOL, atol=TOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), wt.numpy(), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("case", ["n3", "n50"])
def test_udeb_adjoint_twin_equals_the_order_that_rebuilt_each_month(case, monkeypatch):
    """The twin takes each month's adjoint on the tape its single forward
    pass wrote; the order before it ran each month again from its starting
    state, just before the month's adjoint, to rebuild the tape.  Both run
    the same operations on the same values, so they agree."""
    st, arrays, _ = udeb_case(case)
    n = st.n
    rng = np.random.default_rng(12)
    cot = (torch.tensor(rng.normal(size=(2 * n, B))), torch.tensor(rng.normal(size=(8, B))))
    scal, ocean, init, vec = (torch.tensor(a) for a in arrays)
    init = init[:, :1].expand(2 * n, B)
    got = udeb_month.udeb_year_vjp_plain(st, scal, ocean, init, vec, *cot)

    month_vjp = udeb_month._month_vjp_plain
    rebuilt = []

    def rebuilding(st, scal, state, alpha_eff, init_prof, frac, bars, acc, tp):
        fresh = {}
        udeb_month._month_plain(st, scal, *state, alpha_eff, init_prof, frac, tape=fresh)
        rebuilt.append(frac)
        return month_vjp(st, scal, state, alpha_eff, init_prof, frac, bars, acc, fresh)

    monkeypatch.setattr(udeb_month, "_month_vjp_plain", rebuilding)
    want = udeb_month.udeb_year_vjp_plain(st, scal, ocean, init, vec, *cot)
    assert len(rebuilt) == st.steps
    for name, g, w in zip(("scal", "ocean", "init_prof", "vec"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL, err_msg=name)


def test_udeb_adjoint_twin_runs_the_year_forward_once():
    """The twin's arithmetic that does not read the cotangents is one
    forward and the values its reverse pass recomputes from the tape's
    starting states: more than one forward, less than two (the order that
    rebuilt each month ran two)."""
    from rscm_tpu_torch.ops.work import count_arithmetic

    st, arrays, _ = udeb_case("n17-per-member-profile")
    rng = np.random.default_rng(13)
    primals = [torch.tensor(a) for a in arrays]
    cots = [torch.tensor(rng.normal(size=arrays[1].shape)), torch.tensor(rng.normal(size=(8, B)))]
    fwd = count_arithmetic(udeb_month.udeb_year_plain, st, *primals)
    twin = (udeb_month.udeb_year_vjp_plain, st, *primals, *cots)
    on_cotangents = count_arithmetic(*twin, only_from=cots)
    whole = count_arithmetic(*twin)
    for k in range(2):
        assert fwd[k] < whole[k] - on_cotangents[k] < 2 * fwd[k]


def test_udeb_adjoint_twin_rounds_no_worse_than_autograd_in_float32():
    """In float32 at 400 layers each scalar row's cotangent from the twin
    (the adjoint kernel's order) lies as close to the float64 derivative as
    autograd's does, within a factor of two: a sum over a month's rows is
    taken within the month and then added to the year's.  (One running sum
    over all 12 x 2 x 399 rows of the year put ``kappa``'s 3.5x further off
    than autograd's.)"""
    n, b = 400, 16
    comp = ClimateUDEB(n_layers=n)
    st = udeb_month.static_from_component(comp, 1.0)
    arrays = udeb_inputs(comp, 21, b=b)
    rng = np.random.default_rng(22)
    cot = [torch.tensor(c, dtype=torch.float32)
           for c in (rng.normal(size=(2 * n, b)), rng.normal(size=(8, b)))]
    x32 = [torch.tensor(a, dtype=torch.float32) for a in arrays]
    twin = udeb_month.udeb_year_vjp_plain(st, *x32, *cot)[0].double()
    xs = [x.clone().requires_grad_(True) for x in x32]
    auto = torch.autograd.grad(udeb_month.udeb_year_plain(st, *xs), xs, cot)[0].double()
    xs64 = [x.double().requires_grad_(True) for x in x32]
    exact = torch.autograd.grad(udeb_month.udeb_year_plain(st, *xs64), xs64,
                                [c.double() for c in cot])[0]
    off_twin, off_auto = ((g - exact).abs().amax(1) for g in (twin, auto))
    scale = exact.abs().amax(1)
    assert bool((off_twin <= 2.0 * off_auto + 1e-7 * scale).all()), (off_twin, off_auto)


@pytest.mark.parametrize("needs", [(True, False, False, False), (False, True, False, True),
                                   (False, False, True, False), (True, True, True, True)])
def test_udeb_function_backward_gives_the_twins_cotangents_where_needed(needs):
    st, arrays, _ = udeb_case("n3")
    rng = np.random.default_rng(8)
    cot = (torch.tensor(rng.normal(size=(2 * st.n, B))), torch.tensor(rng.normal(size=(8, B))))
    inputs = [torch.tensor(a) for a in arrays]
    twin = udeb_month.udeb_year_vjp_plain(st, *inputs, *cot)
    wrapped = udeb_month.udeb_year_vjp(st, *inputs, *cot, needs=needs)
    xs = [x.clone().requires_grad_(need) for x, need in zip(inputs, needs)]
    outs = udeb_month.UdebYearFunction.apply(st, *xs)
    got = torch.autograd.grad(outs, [x for x in xs if x.requires_grad], cot)
    got = iter(got)
    for need, w, t in zip(needs, wrapped, twin):
        if need:
            assert torch.equal(w, t) and torch.equal(next(got), t)
        else:
            assert w is None


def test_functions_on_cpu_route_backward_to_the_twins(monkeypatch):
    """``backward`` on CPU tensors runs the explicit twins, not autograd of
    the plain forward (and ``jvp`` runs ``plain_jvp``)."""
    calls = []

    def recording(fn):
        def wrapper(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(udeb_month, "udeb_year_vjp_plain",
                        recording(udeb_month.udeb_year_vjp_plain))
    monkeypatch.setattr(lamcalc_kernel, "lamcalc_vjp_plain",
                        recording(lamcalc_kernel.lamcalc_vjp_plain))
    st, arrays, _ = udeb_case("n2")
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    ocean, vec = udeb_month.UdebYearFunction.apply(st, *xs)
    assert "UdebYearFunction" in type(ocean.grad_fn).__name__
    (ocean.sum() + vec.sum()).backward()
    kwargs, fallback, packed = lamcalc_setup(b=4, seed=1)
    lst = lamcalc_kernel.lam_static(LamcalcParams(**kwargs), fallback)
    x = torch.tensor(packed, requires_grad=True)
    lamcalc_kernel.LamcalcFunction.apply(lst, x).sum().backward()
    assert calls == ["udeb_year_vjp_plain", "lamcalc_vjp_plain"]
    assert x.grad is not None and all(t.grad is not None for t in xs)


@pytest.mark.parametrize("case", ["fallback", "no-fallback", "rf-sum-zero", "secant-stall"])
def test_lamcalc_adjoint_twin_matches_jax_vjp_and_autograd(case):
    """Over every branch the adjoint reverses (steps, both secants and, in
    the stalled members, a secant whose denominator vanished), with members
    that stop after different iterations, fallback members and a zero CO2
    forcing pattern."""
    b = 12
    kwargs, fallback, packed = lamcalc_setup(b=b, seed=6)
    if case != "fallback":
        packed[4] = kwargs["rlo"]
    if case == "secant-stall":
        packed[:, :len(STALL_MEMBERS)] = np.array(STALL_MEMBERS).T
    st = lamcalc_kernel.lam_static(LamcalcParams(**kwargs), fallback)
    if case == "rf-sum-zero":
        st = lamcalc_kernel.LamStatic(fg=st.fg, qfrac=st.qfrac, rf_sum_zero=True,
                                      fallback=st.fallback)
    _, iterations = lamcalc_kernel.lamcalc_plain_with_iterations(st, torch.tensor(packed))
    converging = iterations[iterations < lamcalc_kernel.MAX_ITERATIONS - 1]
    assert len(set(converging.tolist())) > 1  # members stop after different iterations
    assert bool((iterations == lamcalc_kernel.MAX_ITERATIONS - 1).any()) == (case == "fallback")
    assert lamcalc_kernel.branch_codes(st, torch.tensor(packed)) == (
        {0, 1, 2, 3} if case == "secant-stall" else {0, 1, 2})

    jax_st = jax_lamcalc.LamStatic(fg=st.fg, qfrac=st.qfrac, rf_sum_zero=st.rf_sum_zero,
                                   fallback=st.fallback)
    member = jax_lamcalc._get_member_fn(jax_st, True)
    cot = np.random.default_rng(9).normal(size=(3, b))
    (want_jax,) = jax.jit(lambda p, c: jax.vjp(
        lambda q: jax.numpy.stack(jax.vmap(member)(*q)), p)[1](c))(packed, cot)
    x = torch.tensor(packed, requires_grad=True)
    (want_torch,) = torch.autograd.grad(lamcalc_kernel.lamcalc_plain(st, x), x, torch.tensor(cot))
    got = lamcalc_kernel.lamcalc_vjp_plain(st, torch.tensor(packed), torch.tensor(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), want_torch.numpy(), rtol=TOL, atol=TOL)
    fallen = (iterations == lamcalc_kernel.MAX_ITERATIONS - 1).numpy()
    assert np.all(got.numpy()[:, fallen] == 0.0)


def test_lamcalc_adjoint_twin_computes_the_cofactors_only_in_its_replay(monkeypatch):
    """The twin's reverse pass solves through M's sparsity (``_Sparse``):
    the cofactor inverse (``_temps``) runs once an iteration of its replay,
    as often as in the forward, and never in the reverse."""
    calls = []
    temps = lamcalc_kernel._temps

    def counted(*args):
        calls.append(1)
        return temps(*args)

    monkeypatch.setattr(lamcalc_kernel, "_temps", counted)
    kwargs, fallback, packed = lamcalc_setup(b=12, seed=6)
    packed[4] = kwargs["rlo"]  # every member converges: the loop stops at the slowest
    st = lamcalc_kernel.lam_static(LamcalcParams(**kwargs), fallback)
    x = torch.tensor(packed)
    _, iterations = lamcalc_kernel.lamcalc_plain_with_iterations(st, x)
    forward = len(calls)
    assert forward == int(iterations.max()) < lamcalc_kernel.MAX_ITERATIONS - 1
    lamcalc_kernel.lamcalc_vjp_plain(st, x, torch.tensor(np.random.default_rng(3).normal(
        size=(3, 12))))
    assert len(calls) == 2 * forward


def test_tangent_work_counts_the_dual_arithmetic_a_tangent_kernel_performs():
    """``count_arithmetic`` of a forward-mode derivative (the tangent
    kernels' work formulas) counts what dual numbers compute: for ``(v *
    2.5 + 1.0) / y`` with ``y`` constant, the value's multiply, add and
    divide and the tangent's multiply and divide; forward mode's primitive
    operations on the constants' zero tangents are not counted."""
    from rscm_tpu_torch.ops.plain_grad import plain_jvp
    from rscm_tpu_torch.ops.work import count_arithmetic

    x, t, y = (torch.tensor(np.random.default_rng(k).normal(size=5)) for k in range(3))
    counted = count_arithmetic(
        lambda a, b: plain_jvp(lambda v: (v * 2.5 + 1.0) / (y + 3.0), (a,), (b,)), x, t)
    assert counted == (3 * 5 + 5, 2 * 5)  # (y + 3.0) is one more addition


def test_only_from_counts_the_arithmetic_that_reads_the_given_tensors():
    """With ``only_from``, ``count_arithmetic`` counts an operation only if
    it reads one of the given tensors, directly or through an earlier
    result: in ``g * (x * 2.5 + 1.0) + g``, the two operations on ``g``,
    not the two that make the factor from ``x`` alone."""
    from rscm_tpu_torch.ops.work import count_arithmetic

    x, g = (torch.tensor(np.random.default_rng(k).normal(size=5)) for k in range(2))

    def fn(a, b):
        return b * (a * 2.5 + 1.0) + b

    assert count_arithmetic(fn, x, g) == (4 * 5, 0)
    assert count_arithmetic(fn, x, g, only_from=(g,)) == (2 * 5, 0)


@pytest.mark.parametrize("kernel, replays", [("udeb_year", 1), ("lamcalc", 1)])
def test_adjoint_work_is_one_forward_and_the_twins_arithmetic_on_cotangents(kernel, replays):
    """An adjoint kernel's work (its roofline bound) counts one forward and
    the arithmetic of its twin that reads the cotangents: not the forwards
    the twin replays (the year's, which writes the tape, for ``udeb_year``;
    the iterations' for ``lamcalc``), nor the forward values its reverse
    pass recomputes, which are the kernel's design and not work the
    function needs (for ``lamcalc`` no cofactors: they come from the
    replay's tape).  (The
    LAMCALC counts are scaled from the slowest member's iterations to the
    iterations each member runs.)"""
    from rscm_tpu_torch.ops.work import count_arithmetic

    rng = np.random.default_rng(4)
    scale = 1.0
    if kernel == "udeb_year":
        st, arrays, _ = udeb_case("n3")
        primals = [torch.tensor(a) for a in arrays]
        cots = [torch.tensor(rng.normal(size=arrays[1].shape)),
                torch.tensor(rng.normal(size=(8, B)))]
        fwd = udeb_month.udeb_year_work(st, *primals)
        work = udeb_month.udeb_year_vjp_work(st, *primals, *cots)
        twin = (udeb_month.udeb_year_vjp_plain, st, *primals, *cots)
    else:
        kwargs, fallback, packed = lamcalc_setup(b=8, seed=2)
        st = lamcalc_kernel.lam_static(LamcalcParams(**kwargs), fallback)
        primals = [torch.tensor(packed)]
        cots = [torch.tensor(rng.normal(size=(3, 8)))]
        fwd = lamcalc_kernel.lamcalc_work(st, *primals)
        work = lamcalc_kernel.lamcalc_vjp_work(st, *primals, *cots)
        twin = (lamcalc_kernel.lamcalc_vjp_plain, st, *primals, *cots)
        iterations = lamcalc_kernel.lamcalc_plain_with_iterations(st, *primals)[1].double()
        scale = float(iterations.sum() / (8 * iterations.max()))
    on_cotangents = [c * scale for c in count_arithmetic(*twin, only_from=cots)]
    whole = [c * scale for c in count_arithmetic(*twin)]
    for k in range(2):
        assert work[k] == pytest.approx(fwd[k] + on_cotangents[k], rel=1e-12)
        assert whole[k] - on_cotangents[k] > replays * fwd[k]
    if kernel == "lamcalc":
        # the reverse pass recomputes no cofactors: its own values (the
        # ratio, M's entries and the solve's coefficients) cost under a
        # quarter of a forward's additions and multiplications
        assert whole[0] - on_cotangents[0] < 1.25 * fwd[0]
