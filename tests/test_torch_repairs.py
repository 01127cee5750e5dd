"""Two faults of the port, repaired, and the JAX package's remaining
``xmath`` functions.

- A float32 run keeps every state and trajectory in float32: host-scalar
  branches of ``xmath.where`` take the year loop's dtype (SeaLevelRise's
  glacier solve computed in float64 before).  The float32 run is held
  against the port's own float64 run: the reference's float32 ensembles
  with permafrost or sea level fail in ``lax.scan``.
- ClimateUDEB takes the reference's ``tridiag_solver`` and its engine names
  ``"xla"`` / ``"pallas"``; ``"assoc"`` runs ``thomas_solve_assoc``, held
  at 1e-12 against the reference's in float64 and, through a whole run, at
  1e-9 against the reference's ``"assoc"`` run.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_support import UDEB_OUTPUTS, build_udeb, step_erf, values

FULL_YEARS = np.arange(1850.0, 1856.0)
#: float32 against float64: max |f32 - f64| over the variable's largest |f64|,
#: or over SMALL for a variable that stays near zero (the thawed permafrost
#: fraction is ~1e-16 in float64 and float32's 6e-8 after six years)
FLOAT32_REL = 1e-4
SMALL = 1e-2
#: operators that only bring numpy data in: their float64 output is cast at once
CREATION = {"lift_fresh", "lift_fresh_copy"}


class Float64Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        outs = out if isinstance(out, (tuple, list)) else [out]
        if name not in CREATION and any(
            isinstance(o, torch.Tensor) and o.dtype == torch.float64 for o in outs
        ):
            self.seen.add(name)
        return out


def full_options_run(dtype, count=None):
    from rscm_tpu_torch.magicc.coupled import build_magicc_model
    from rscm_tpu_torch.parallel import EnsembleRunner

    model = build_magicc_model(years=FULL_YEARS, include_permafrost=True, include_slr=True)
    runner = EnsembleRunner(model, dtype=dtype, device="cpu")
    batched, baked = runner._split_params(
        runner.batched_params({"ClimateUDEB.ecs": np.array([2.5, 3.0, 4.0])}))
    params = {nk: {**baked.get(nk, {}), **batched.get(nk, {})} for nk in {*baked, *batched}}
    endo = {k: v.expand(-1, 3, -1) for k, v in runner.program.gather_endo(1).items()}
    args = (endo, runner.program.gather_exo(), params, runner.program.gather_internals())
    with count or torch.no_grad():
        return runner.program.run_fn(*args)


def leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    return [tree]


def test_float32_full_options_run_stays_float32():
    count = Float64Ops()
    endo32, internals32 = full_options_run(torch.float32, count)
    assert not count.seen, f"float64 arithmetic in a float32 run: {sorted(count.seen)}"
    for name, traj in endo32.items():
        assert traj.dtype == torch.float32, name
    floating = [x for x in leaves(internals32) if isinstance(x, torch.Tensor)
                and x.is_floating_point()]
    assert floating
    assert all(x.dtype == torch.float32 for x in floating)
    slr = next(k for k, v in internals32.items() if isinstance(v, dict) and "gl" in v)
    assert internals32[slr]["gl"].dtype == torch.float32

    endo64, _ = full_options_run(torch.float64)
    for name, traj in endo64.items():
        want = traj[1:].numpy()
        got = endo32[name][1:].double().numpy()
        scale = max(np.nanmax(np.abs(want)), SMALL)
        assert np.isfinite(got).all() == np.isfinite(want).all(), name
        err = np.nanmax(np.abs(got - want)) / scale
        assert err < FLOAT32_REL, f"{name}: {err:.2e}"


def test_where_takes_the_loop_dtype_for_host_branches():
    from rscm_tpu_torch.core import xmath as xm

    pred = torch.tensor([True, False])
    exact = xm.where(pred, 13.83, 0.0)  # float64 outside a loop: exact
    assert exact.dtype == torch.float64 and float(exact[0]) == 13.83
    with xm.scalar_dtype(torch.float32):
        assert xm.where(pred, -1.0, 1.0).dtype == torch.float32
        # a floating branch still decides
        assert xm.where(pred, torch.zeros(2, dtype=torch.float64), 1.0).dtype == torch.float64
    assert xm.where(pred, -1.0, 1.0).dtype == torch.float64


@pytest.mark.parametrize("n", [1, 2, 3, 17, 50])
def test_thomas_solve_assoc_matches_reference(n):
    from rscm_tpu.utils.linear_algebra import thomas_solve_assoc as reference
    from rscm_tpu_torch.utils.linear_algebra import thomas_solve_assoc, thomas_solve_batched

    rng = np.random.default_rng(n)
    a, c = rng.uniform(-1.0, 0.0, (2, 4, n))
    b = 2.5 + rng.uniform(0.0, 1.0, (4, n))
    d = rng.normal(size=(4, n))
    want = np.asarray(reference(a, b, c, d))
    got = thomas_solve_assoc(*(torch.tensor(x) for x in (a, b, c, d))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    sequential = thomas_solve_batched(*(torch.tensor(x) for x in (a, b, c, d))).numpy()
    np.testing.assert_allclose(got, sequential, rtol=1e-12, atol=1e-12)


def test_udeb_assoc_solver_matches_reference():
    """Mirror of ``tests/test_udeb_traced.py::test_assoc_tridiag_matches_sequential``
    across the packages: the port's torch engine with ``"assoc"`` against the
    reference's compiled ``"assoc"`` run (80 years)."""
    years = np.arange(1850.0, 1930.0)
    erf = step_erf(years)
    ref = build_udeb("rscm_tpu", years, erf, month_engine="xla", tridiag_solver="assoc")
    ref.run(compiled=True)
    port = build_udeb("rscm_tpu_torch", years, erf, tridiag_solver="assoc")
    port.run(device="cpu")
    for name in UDEB_OUTPUTS:
        got = values(port, name)
        assert np.isfinite(got[1:]).all(), name
        np.testing.assert_allclose(got, values(ref, name), rtol=1e-9, atol=1e-9, err_msg=name)
    seq = build_udeb("rscm_tpu_torch", years, erf)
    seq.run(device="cpu")
    np.testing.assert_allclose(values(port, "Heat Uptake"), values(seq, "Heat Uptake"),
                               rtol=1e-8, atol=1e-8)


def test_jax_engine_names_are_aliases():
    """``month_engine="xla"`` runs the torch engine on the CPU and
    ``"pallas"`` the kernel's wrapper (its plain version on CPU tensors):
    both give the port's own engines' numbers exactly."""
    years = np.arange(1850.0, 1862.0)
    erf = step_erf(years)
    runs = {}
    for engine in ("torch", "xla", "cuda", "pallas"):
        model = build_udeb("rscm_tpu_torch", years, erf, month_engine=engine)
        model.run(device="cpu")
        runs[engine] = values(model, "Surface Temperature")
    np.testing.assert_array_equal(runs["xla"], runs["torch"])
    np.testing.assert_array_equal(runs["pallas"], runs["cuda"])
    with pytest.raises(ValueError, match="tridiag_solver"):
        build_udeb("rscm_tpu_torch", years[:3], erf[:3], tridiag_solver="cyclic").run(
            device="cpu")


def test_static_params_carry_the_tridiag_solver():
    from rscm_tpu_torch.convert import static_params_from_jax

    years = np.arange(1850.0, 1853.0)
    ref = build_udeb("rscm_tpu", years, step_erf(years), month_engine="xla",
                     tridiag_solver="assoc")
    (statics,) = static_params_from_jax(ref).values()
    assert statics["tridiag_solver"] == "assoc"
    assert statics["month_engine"] == "torch"


XMATH = ["sin", "cos", "arctan", "sinh", "cosh", "floor", "ceil", "log2", "log10", "mean",
         "nan_to_num"]


@pytest.mark.parametrize("name", XMATH)
def test_xmath_leftovers_match_reference(name):
    """The reference's ``xmath`` on host values and traced arrays against
    the port's on host values and tensors, float64, at 1e-12."""
    import jax
    import jax.numpy as jnp

    from rscm_tpu.core import xmath as ref_xm
    from rscm_tpu_torch.core import xmath as xm

    rng = np.random.default_rng(len(name))
    x = rng.uniform(0.5, 3.0, (3, 5)) * rng.choice([-1.0, 1.0], (3, 5))
    if name in ("log2", "log10"):
        x = np.abs(x)
    if name == "nan_to_num":
        x[0, 0], x[1, 1], x[2, 2] = np.nan, np.inf, -np.inf
    want_host = np.asarray(getattr(ref_xm, name)(x))
    got_host = getattr(xm, name)(x)
    assert not isinstance(got_host, torch.Tensor)
    np.testing.assert_allclose(np.asarray(got_host), want_host, rtol=1e-12, atol=1e-12)
    want_traced = np.asarray(jax.jit(getattr(ref_xm, name))(jnp.asarray(x)))
    got_tensor = getattr(xm, name)(torch.tensor(x))
    assert isinstance(got_tensor, torch.Tensor)
    np.testing.assert_allclose(got_tensor.numpy(), want_traced, rtol=1e-12, atol=1e-12)
    scalar = float(x[1, 0])
    if name != "mean":
        np.testing.assert_allclose(float(getattr(xm, name)(scalar)),
                                   float(getattr(ref_xm, name)(scalar)), rtol=1e-12)
