"""The port's kernel modules against the JAX package's plain paths.

``rscm_tpu_torch.ops.udeb_month`` and ``rscm_tpu_torch.ops.lamcalc_kernel``
each hold a CUDA kernel and its plain PyTorch version.  On the CPU the
wrappers run the plain versions, which must do the JAX package's
arithmetic: the same packed float64 inputs, made from a numpy seed, go
through both and agree to rtol 1e-12.  The kernels themselves run only on a
CUDA card (``gpu`` marker).
"""

import jax
import numpy as np
import pytest
import torch

from rscm_tpu.magicc import ClimateUDEB as JaxUDEB
from rscm_tpu.magicc.climate.lamcalc import LamcalcParams as JaxLamcalcParams
from rscm_tpu.magicc.climate.lamcalc import lamcalc_traced
from rscm_tpu.ops import lamcalc_kernel as jax_lamcalc
from rscm_tpu.ops import udeb_month as jax_udeb
from rscm_tpu_torch.magicc import ClimateUDEB
from rscm_tpu_torch.magicc.climate.lamcalc import LamcalcParams
from rscm_tpu_torch.ops import lamcalc_kernel, udeb_month

RTOL = 1e-12
B = 16


def udeb_inputs(comp, seed, b=B):
    """Packed member-minor inputs of one UDEB year, as numpy float64."""
    rng = np.random.default_rng(seed)
    n = comp.n_layers

    def u(lo, hi):
        return rng.uniform(lo, hi, b)

    def full(v):
        return np.full(b, float(v))

    scal = np.stack([
        u(0.5, 2.5), u(1.0, 3.0), u(0.4, 1.5), full(comp.kappa_dkdt),
        full(comp.kappa_min_m2_per_yr()), full(comp.w_initial), u(0.0, 0.7),
        full(comp.k_lo), full(comp.k_ns), full(comp.k_lg), full(comp.amplify_ocean_to_land),
        full(comp.polar_sinking_ratio), full(comp.temp_adjust_alpha),
        full(comp.temp_adjust_gamma), full(comp.max_temperature),
        full(comp.ground_heat_capacity()), u(0.0, 8.0), u(0.0, 8.0), full(1.0),
        full(comp.w_threshold_temp_nh), full(comp.w_threshold_temp_sh),
    ])
    ocean = rng.uniform(0.0, 4.0, (2 * n, b))
    init = np.repeat(
        np.asarray(comp.create_initial_state()["initial_ocean_profile"]).reshape(2 * n, 1),
        b, axis=1,
    )
    vec = np.concatenate([
        rng.uniform(0.0, 4.0, (4, b)), rng.uniform(-0.5, 0.5, (2, b)),
        rng.uniform(1.0, 3.5, (2, b)), rng.uniform(1.0, 1.04, (2, b)),
    ])
    return scal, ocean, init, vec


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("params", [
    {}, {"land_heat_capacity_enabled": False},
    # no interior layer, one interior layer, an odd count
    {"n_layers": 2}, {"n_layers": 3}, {"n_layers": 17},
])
def test_udeb_year_plain_matches_months_jnp(params, seed):
    jax_comp, comp = JaxUDEB(**params), ClimateUDEB(**params)
    arrays = udeb_inputs(comp, seed)
    want_ocean, want_vec = jax.jit(
        lambda *a: jax_udeb._months_jnp(jax_udeb._static_from_component(jax_comp), *a)
    )(*arrays)

    st = udeb_month.static_from_component(comp, 1.0)
    got_ocean, got_vec = udeb_month.udeb_year_plain(st, *(torch.tensor(a) for a in arrays))
    np.testing.assert_allclose(got_ocean.numpy(), np.asarray(want_ocean), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(got_vec.numpy(), np.asarray(want_vec), rtol=RTOL, atol=1e-12)


def test_udeb_wrapper_takes_the_plain_version_on_cpu():
    comp = ClimateUDEB()
    st = udeb_month.static_from_component(comp, 1.0)
    scal, ocean, init, vec = (torch.tensor(a) for a in udeb_inputs(comp, 3))
    # the shared profile as a broadcast view, as the component passes it
    init = init[:, :1].expand(-1, B)
    before = udeb_month.udeb_year.launches
    got = udeb_month.udeb_year(st, scal, ocean, init, vec)
    want = udeb_month.udeb_year_plain(st, scal, ocean, init.contiguous(), vec)
    assert udeb_month.udeb_year.launches == before  # nothing launched on the CPU
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="rows"):
        udeb_month.udeb_year(st, scal[:-1], ocean, init, vec)


# 410 is past the kernel's float64 limit: the plain version has none
@pytest.mark.parametrize("n_layers", [2, 17, 410])
def test_udeb_wrapper_takes_the_plain_version_on_cpu_at_any_layer_count(n_layers):
    comp = ClimateUDEB(n_layers=n_layers)
    st = udeb_month.static_from_component(comp, 1.0)
    scal, ocean, init, vec = (torch.tensor(a) for a in udeb_inputs(comp, 4, b=4))
    before = udeb_month.udeb_year.launches
    got = udeb_month.udeb_year(st, scal, ocean, init, vec)
    want = udeb_month.udeb_year_plain(st, scal, ocean, init, vec)
    assert udeb_month.udeb_year.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].shape == (2 * n_layers, 4)


@pytest.fixture
def stub_udeb_library(monkeypatch):
    """The kernel's library replaced by one that states a layer limit of 409
    (float64) / 818 (float32) and fails every other call."""
    from types import SimpleNamespace

    from rscm_tpu_torch.ops import build

    def unexpected(*args):
        raise AssertionError("called past the layer check")

    lib = SimpleNamespace(
        udeb_year_max_layers_f64=lambda: 409, udeb_year_max_layers_f32=lambda: 818,
        udeb_year_config_f64=unexpected, udeb_year_config_f32=unexpected,
    )
    monkeypatch.setattr(build, "load", lambda name: lib)
    udeb_month.max_kernel_layers.cache_clear()
    yield {torch.float64: 409, torch.float32: 818}
    udeb_month.max_kernel_layers.cache_clear()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_udeb_kernel_layer_limit_is_the_librarys(stub_udeb_library, dtype):
    limit = stub_udeb_library[dtype]
    assert udeb_month.max_kernel_layers(dtype) == limit
    udeb_month._check_layers(limit, dtype)
    # above the limit the kernel path raises before it asks for a launch
    # configuration, and says why
    with pytest.raises(ValueError, match=f"at most {limit} layers.*shared memory"):
        udeb_month.kernel_config(limit + 1, dtype)


def lamcalc_setup(b=B, seed=0):
    """LAMCALC parameters in both packages and packed inputs; every fourth
    member asks for an unreachable warming ratio and takes the fallback."""
    comp = ClimateUDEB()
    fgno, fgnl, fgso, fgsl = comp.global_box_fractions()
    kwargs = dict(
        q_2xco2=comp.rf_2xco2, k_lo=comp.k_lo, k_ns=comp.k_ns, ecs=comp.ecs, rlo=comp.rlo,
        amplify_ocean_to_land=comp.amplify_ocean_to_land,
        fgno=fgno, fgnl=fgnl, fgso=fgso, fgsl=fgsl, rf_regions_co2=tuple(comp.rf_regions_co2),
    )
    fallback = (comp.lambda_ocean, comp.lambda_land, comp.matrix_inverse,
                comp.co2_internal_efficacy)
    rng = np.random.default_rng(seed)
    rlo = np.full(b, comp.rlo)
    rlo[::4] = 100.0
    packed = np.stack([
        rng.uniform(1.8, 5.5, b), np.full(b, comp.rf_2xco2), rng.uniform(1.0, 2.0, b),
        np.full(b, comp.k_ns), rlo, np.full(b, comp.amplify_ocean_to_land),
    ])
    return kwargs, fallback, packed


#: (6,) inputs of members whose first iterate lies on the land/ocean warming
#: ratio's pole (``rlo`` set to its last bits): their secants stall on one
#: iterate until a denominator vanishes (branch code 3), and they converge
#: at iteration 10 under ``lamcalc_setup``'s box fractions in float64
STALL_MEMBERS = [
    [1.2633767549784332, 7.437325381688504, 0.1080402269320665, 0.6036191807589846, rlo,
     0.6940602750934692]
    for rlo in (0.21437001022807176, 0.21437001022807184)
]


def test_lamcalc_plain_matches_ref_jnp_with_fallback_members():
    kwargs, fallback, packed = lamcalc_setup()
    st = lamcalc_kernel.lam_static(LamcalcParams(**kwargs), fallback)
    jax_st = jax_lamcalc.LamStatic(
        fg=st.fg, qfrac=st.qfrac, rf_sum_zero=st.rf_sum_zero, fallback=st.fallback
    )
    want = jax.jit(lambda *rows: jax_lamcalc._ref_jnp(jax_st, *rows))(*packed)
    got, iterations = lamcalc_kernel.lamcalc_plain_with_iterations(st, torch.tensor(packed))
    assert int((iterations == 39).sum()) == B // 4  # the fallback members never converge
    assert bool((iterations < 39).sum() == B - B // 4)
    np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(w) for w in want]),
                               rtol=RTOL, atol=1e-12)
    np.testing.assert_array_equal(got[:, ::4].numpy(), np.array(st.fallback)[:, None]
                                  * np.ones((1, B // 4)))


def test_lamcalc_plain_matches_lamcalc_traced():
    kwargs, fallback, packed = lamcalc_setup(seed=1)

    def traced(ecs, k_lo, rlo):
        params = JaxLamcalcParams(**{**kwargs, "ecs": ecs, "k_lo": k_lo, "rlo": rlo})
        lam_o, lam_l, _inv, eff = lamcalc_traced(params, ecs, fallback)
        return lam_o, lam_l, eff

    want = jax.jit(jax.vmap(traced))(packed[0], packed[2], packed[4])
    port = LamcalcParams(**{**kwargs, "k_lo": torch.tensor(packed[2]),
                            "rlo": torch.tensor(packed[4])})
    got = lamcalc_kernel.lamcalc_scalars(port, torch.tensor(packed[0]), fallback, engine="torch")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-12)


def test_lamcalc_wrapper_takes_the_plain_version_on_cpu():
    kwargs, fallback, packed = lamcalc_setup(seed=2)
    st = lamcalc_kernel.lam_static(LamcalcParams(**kwargs), fallback)
    before = lamcalc_kernel.lamcalc.launches
    got = lamcalc_kernel.lamcalc(st, torch.tensor(packed))
    assert lamcalc_kernel.lamcalc.launches == before
    assert torch.equal(got, lamcalc_kernel.lamcalc_plain(st, torch.tensor(packed)))
    with pytest.raises(ValueError, match="input must be"):
        lamcalc_kernel.lamcalc(st, torch.tensor(packed[:5]))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_layers", [2, 3, 17, 50])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_match_plain_versions_on_card(cuda, dtype, n_layers):
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    comp = ClimateUDEB(n_layers=n_layers)
    st = udeb_month.static_from_component(comp, 1.0)
    args = [torch.tensor(a, dtype=dtype, device=cuda) for a in udeb_inputs(comp, 0, b=1001)]
    before = udeb_month.udeb_year.launches
    for g, w in zip(udeb_month.udeb_year(st, *args), udeb_month.udeb_year_plain(st, *args)):
        torch.testing.assert_close(g, w, rtol=rtol, atol=rtol)
    assert udeb_month.udeb_year.launches == before + 1

    kwargs, fallback, packed = lamcalc_setup(b=1001)
    lst = lamcalc_kernel.lam_static(LamcalcParams(**kwargs), fallback)
    x = torch.tensor(packed, dtype=dtype, device=cuda)
    torch.testing.assert_close(lamcalc_kernel.lamcalc(lst, x),
                               lamcalc_kernel.lamcalc_plain(lst, x), rtol=rtol, atol=rtol)
    # the gradient goes through the adjoint kernel, which equals its twin
    xg = x.clone().requires_grad_(True)
    before = lamcalc_kernel.lamcalc_vjp.launches
    (grad,) = torch.autograd.grad(lamcalc_kernel.lamcalc(lst, xg).sum(), xg)
    assert lamcalc_kernel.lamcalc_vjp.launches == before + 1
    torch.testing.assert_close(grad, lamcalc_kernel.lamcalc_vjp_plain(
        lst, x, torch.ones((3, x.shape[1]), dtype=dtype, device=cuda)), rtol=rtol, atol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_takes_its_layer_limit_on_card(cuda, dtype):
    limit = udeb_month.max_kernel_layers(dtype)
    assert limit >= 400  # well above the default of 50 layers
    for n in (limit, limit + 1):
        comp = ClimateUDEB(n_layers=n)
        st = udeb_month.static_from_component(comp, 1.0)
        args = [torch.tensor(a, dtype=dtype, device=cuda) for a in udeb_inputs(comp, 1, b=65)]
        if n > limit:
            with pytest.raises(ValueError, match=f"at most {limit} layers"):
                udeb_month.udeb_year(st, *args)
            continue
        for g, w in zip(udeb_month.udeb_year(st, *args), udeb_month.udeb_year_plain(st, *args)):
            assert torch.equal(g, w)


def test_kernel_build_names_libraries_by_source_and_flags(tmp_path, monkeypatch):
    from rscm_tpu_torch.ops import build

    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = build._target("k")
    (tmp_path / "k.cu").write_text("// two\n")
    assert build._target("k") != first
    assert build._target("k").parent == build.BUILD_DIR


def test_kernel_build_fails_loudly_without_nvcc(tmp_path, monkeypatch):
    from rscm_tpu_torch.ops import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("udeb_year")


def test_ptxas_summary_keeps_register_and_spill_lines():
    from rscm_tpu_torch.ops.build import ptxas_summary

    report = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function 'k' for 'sm_90a'",
        "ptxas info    : Function properties for k",
        "    1768 bytes stack frame, 2520 bytes spill stores, 2768 bytes spill loads",
        "ptxas info    : Used 255 registers, used 0 barriers",
    ])
    assert ptxas_summary(report) == [
        "ptxas info    : Compiling entry function 'k' for 'sm_90a'",
        "1768 bytes stack frame, 2520 bytes spill stores, 2768 bytes spill loads",
        "ptxas info    : Used 255 registers, used 0 barriers",
    ]
