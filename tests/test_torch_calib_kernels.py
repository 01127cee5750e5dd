"""Gradients through both kernels: the port's ``torch.autograd.Function``s.

Neither Pallas kernel of the JAX package has a backward kernel: each sits
in a ``jax.custom_jvp`` whose rule differentiates the kernel's ``jnp``
reference.  The port's ``UdebYearFunction`` and ``LamcalcFunction`` launch
a forward, a tangent and an adjoint CUDA kernel on the card.  Here, on the
CPU, each Function runs with the plain version as its forward, ``plain_jvp``
of it as its ``jvp`` and the adjoint kernel's explicit twin
(``udeb_year_vjp_plain``, ``lamcalc_vjp_plain``) as its ``backward`` (a
CUDA kernel runs only on the card, ``chip_smoke.py``), so the reverse-mode
checks below hold the twins' derivation:

- ``torch.autograd.gradcheck`` (reverse and forward mode, in its fast
  mode: random projections of the Jacobian) passes on tiny float64 inputs;
- the Function's forward-mode tangents and reverse-mode cotangents equal
  the JAX ``custom_jvp`` rule's (``jax.jvp`` / ``jax.vjp`` of the JAX
  package's member function under ``vmap``) on the same inputs within
  1e-12 (both differentiate the same arithmetic in float64).
"""

import jax
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from rscm_tpu.magicc import ClimateUDEB as JaxUDEB
from rscm_tpu.ops import lamcalc_kernel as jax_lamcalc
from rscm_tpu.ops import udeb_month as jax_udeb
from rscm_tpu_torch.magicc import ClimateUDEB
from rscm_tpu_torch.magicc.climate.lamcalc import LamcalcParams
from rscm_tpu_torch.ops import lamcalc_kernel, udeb_month
from test_torch_kernels import lamcalc_setup, udeb_inputs

TOL = 1e-12


def udeb_case(n_layers, b, seed):
    comp = ClimateUDEB(n_layers=n_layers)
    st = udeb_month.static_from_component(comp, 1.0)
    arrays = udeb_inputs(comp, seed, b=b)
    return comp, st, arrays


@pytest.mark.parametrize("n_layers", [2, 3])
def test_udeb_function_gradcheck(n_layers):
    _, st, arrays = udeb_case(n_layers, 2, seed=n_layers)
    inputs = tuple(torch.tensor(a, requires_grad=True) for a in arrays)
    assert torch.autograd.gradcheck(
        lambda *x: udeb_month.UdebYearFunction.apply(st, *x), inputs,
        check_forward_ad=True, check_undefined_grad=False, fast_mode=True,
    )


def test_lamcalc_function_gradcheck():
    kwargs, fallback, packed = lamcalc_setup(b=4, seed=3)
    st = lamcalc_kernel.lam_static(LamcalcParams(**kwargs), fallback)
    x = torch.tensor(packed[:, 1:3], requires_grad=True)  # one converging member, one more
    assert torch.autograd.gradcheck(
        lambda p: lamcalc_kernel.LamcalcFunction.apply(st, p), (x,),
        check_forward_ad=True, check_undefined_grad=False, fast_mode=True,
    )


def port_jvp_vjp(apply, inputs, tangents, cotangents):
    """The Function's forward-mode tangents and reverse-mode cotangents."""
    with fwAD.dual_level():
        outs = apply(*(fwAD.make_dual(x, t) for x, t in zip(inputs, tangents)))
        outs = outs if isinstance(outs, tuple) else (outs,)
        jvp = [fwAD.unpack_dual(o).tangent for o in outs]
    xs = [x.clone().requires_grad_(True) for x in inputs]
    outs = apply(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    vjp = torch.autograd.grad(outs, xs, cotangents)
    return jvp, vjp


@pytest.mark.parametrize("n_layers", [3, 17])
def test_udeb_function_tangents_match_the_jax_custom_jvp_rule(n_layers):
    b = 4
    comp, st, arrays = udeb_case(n_layers, b, seed=10 + n_layers)
    rng = np.random.default_rng(n_layers)
    tangents = [rng.normal(size=a.shape) for a in arrays]
    cot = [rng.normal(size=(2 * n_layers, b)), rng.normal(size=(8, b))]

    # the JAX package's member function (custom_jvp around the Pallas call),
    # per member under vmap, on member-major copies of the same inputs
    member = jax_udeb._get_member_fn(jax_udeb._static_from_component(JaxUDEB(n_layers=n_layers)), True)

    def jax_fn(scal, ocean, init, vec):
        o, v = jax.vmap(member)(scal.T, ocean.T.reshape(b, 2, n_layers),
                                init.T.reshape(b, 2, n_layers), vec.T)
        return o.reshape(b, 2 * n_layers).T, v.T

    want_jvp = jax.jit(lambda p, t: jax.jvp(jax_fn, p, t)[1])(tuple(arrays), tuple(tangents))
    want_vjp = jax.jit(lambda p, c: jax.vjp(jax_fn, *p)[1](c))(tuple(arrays), tuple(cot))

    got_jvp, got_vjp = port_jvp_vjp(
        lambda *x: udeb_month.UdebYearFunction.apply(st, *x),
        [torch.tensor(a) for a in arrays], [torch.tensor(t) for t in tangents],
        [torch.tensor(c) for c in cot],
    )
    for g, w in zip(got_jvp, want_jvp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    for g, w in zip(got_vjp, want_vjp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("with_fallback", [True, False])
def test_lamcalc_function_tangents_match_the_jax_custom_jvp_rule(with_fallback):
    """With fallback members (every fourth takes the fallback constants: its
    tangents are 0 in both packages) the plain loop runs all its steps;
    without, it stops once every member has converged, and the tangents
    are still the JAX package's fixed-count loop's."""
    b = 8
    kwargs, fallback, packed = lamcalc_setup(b=b, seed=4)
    if not with_fallback:
        packed[4] = kwargs["rlo"]
    st = lamcalc_kernel.lam_static(LamcalcParams(**kwargs), fallback)
    jax_st = jax_lamcalc.LamStatic(fg=st.fg, qfrac=st.qfrac, rf_sum_zero=st.rf_sum_zero,
                                   fallback=st.fallback)
    member = jax_lamcalc._get_member_fn(jax_st, True)
    rng = np.random.default_rng(5)
    tangent = rng.normal(size=packed.shape)
    cot = rng.normal(size=(3, b))

    def jax_fn(p):
        return jax.numpy.stack(jax.vmap(member)(*p))

    want_jvp = jax.jit(lambda p, t: jax.jvp(jax_fn, (p,), (t,))[1])(packed, tangent)
    (want_vjp,) = jax.jit(lambda p, c: jax.vjp(jax_fn, p)[1](c))(packed, cot)

    (got_jvp,), (got_vjp,) = port_jvp_vjp(
        lambda p: lamcalc_kernel.LamcalcFunction.apply(st, p),
        [torch.tensor(packed)], [torch.tensor(tangent)], [torch.tensor(cot)],
    )
    np.testing.assert_allclose(got_jvp.numpy(), np.asarray(want_jvp), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_vjp.numpy(), np.asarray(want_vjp), rtol=TOL, atol=TOL)
    if with_fallback:
        assert np.all(got_jvp.numpy()[:, ::4] == 0.0)
        assert np.all(got_vjp.numpy()[:, ::4] == 0.0)
    else:
        _, iterations = lamcalc_kernel.lamcalc_plain_with_iterations(st, torch.tensor(packed))
        assert int(iterations.max()) < lamcalc_kernel.MAX_ITERATIONS - 1


def test_wrappers_on_cpu_differentiate_the_plain_version_directly():
    """On CPU tensors the wrappers run the plain version and autograd goes
    through it; the Function is the path of CUDA tensors only."""
    _, st, arrays = udeb_case(3, 2, seed=7)
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    ocean, _ = udeb_month.udeb_year(st, *xs)
    assert "UdebYearFunction" not in type(ocean.grad_fn).__name__
    kwargs, fallback, packed = lamcalc_setup(b=4, seed=8)
    st = lamcalc_kernel.lam_static(LamcalcParams(**kwargs), fallback)
    out = lamcalc_kernel.lamcalc(st, torch.tensor(packed, requires_grad=True))
    assert "LamcalcFunction" not in type(out.grad_fn).__name__
