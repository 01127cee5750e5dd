"""
One year of ClimateUDEB monthly sub-steps per member: a CUDA kernel and its
plain PyTorch version, and the year's tangent and adjoint kernels with
theirs (:func:`udeb_year_jvp`, :func:`udeb_year_vjp`).

Replaces the Pallas kernel ``rscm_tpu/ops/udeb_month.py::udeb_year_update``
(``pallas_call`` at ``udeb_month.py:400``, body ``_month_body`` at
``:87-277``).  For every member it runs the twelve monthly sub-steps of a
year: ground-heat damping, the implicit diffusion/upwelling tridiagonal
system of both hemispheric ocean columns (2 x n layers) and its Thomas
sweep, the clamp at the maximum temperature, the SST->air map, land
temperatures, interhemispheric exchange and the upwelling update.

Layout is member-minor, as the Pallas caller builds it: every input is
``(rows, B)`` so that member ``m`` of row ``r`` sits at ``r * B + m``.

- ``scal`` ``(S + 2, B)``: the :data:`SCALAR_ROWS` plus the two upwelling
  threshold temperatures;
- ``ocean`` and ``init_prof`` ``(2 n, B)``: hemisphere-major ocean columns
  (``init_prof`` may be a broadcast view, e.g. ``(2 n, 1)`` expanded);
- ``vec`` ``(10, B)``: land(2), ground(2), hemispheric exchange(2),
  upwelling(2), effective SST->air ratio(2).

Outputs are ``ocean`` ``(2 n, B)`` and ``vec`` ``(8, B)`` (the first eight
rows of the input ``vec``, updated).

**The CUDA kernel** (``csrc/udeb_year.cu``): two threads per member, one
for each hemisphere's column, so neighbouring threads read neighbouring
addresses of every row; the ragged tail is masked.  The layer count n is a
run-time argument.  Each thread keeps its column and its Thomas
coefficients in shared memory, laid out ``[layer][thread]``; the per-layer
geometry (:func:`_geom`, a device buffer cached per configuration) and a
broadcast initial profile are staged into shared memory once per block;
the leading constants are passed by value.  A block of one warp must fit
the 227 KB a block may use, which bounds n (:func:`max_kernel_layers`
asks the kernel's library: 409 layers in float64, 818 in float32); the
wrapper raises above it.

*What bounds it on an H100:* operations.  A member-year is 2 columns x 12
months x n layers of a serial Thomas step, each ~40 additions and
multiplications and 2 IEEE divisions, against ~(4n + 40) values in and
out.  *What the design does about it:* every intermediate stays on the SM
(registers and shared memory, no local memory), and the two hemispheres
run on two threads, which doubles the independent chains in flight; the
pair swaps its air and land temperatures with a warp shuffle for the
step that couples them.  The forward sweep forms the next row's
coefficients before the current row's divisions, so that they fill the
divisions' latency.

**The plain version** (:func:`udeb_year_plain`): the same operations in
the same order on ``(2, n, B)`` tensors — the twin of the JAX package's
``_months_jnp``.  The layer assembly is vectorised over layers and the
Thomas sweep runs layer by layer; each element still sees exactly the
operations the kernel performs.  PyTorch's CUDA division of a tensor by a
host scalar multiplies by the scalar's reciprocal, so the kernel does the
same with reciprocals precomputed in the working dtype (:func:`_geom`).

**The derivatives** (:class:`UdebYearFunction`): on CUDA tensors the
tangent kernel (forward mode, the month on dual numbers) and the adjoint
kernel (reverse mode: the year's forward once, writing a tape, then each
month's adjoint from the twelfth to the first on its tape), in the same
source; their plain versions are ``plain_jvp`` of :func:`udeb_year_plain`
and the explicit twin :func:`udeb_year_vjp_plain`, which performs the
adjoint kernel's operations in its order.  Each wrapper's docstring states what bounds its
kernel and what the design does about it.
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.linear_algebra import thomas_solve_assoc
from .plain_grad import plain_jvp
from .work import count_arithmetic, note_launch

__all__ = [
    "udeb_year",
    "udeb_year_plain",
    "UdebYearFunction",
    "UdebStatic",
    "SCALAR_ROWS",
    "static_from_component",
    "max_kernel_layers",
    "kernel_config",
    "udeb_year_work",
    "udeb_year_jvp",
    "udeb_year_jvp_work",
    "udeb_year_vjp",
    "udeb_year_vjp_plain",
    "udeb_year_vjp_work",
]

#: packed per-member scalar rows, in order
SCALAR_ROWS = (
    "lam_o", "lam_l", "kappa", "kappa_dkdt", "kappa_min",
    "w_initial", "w_var_frac", "k_lo", "k_ns", "k_lg",
    "amplify", "pi_ratio", "adj_alpha", "adj_gamma", "max_temp",
    "c_ground", "erf_start", "erf_end", "t_polar",
)
S = len(SCALAR_ROWS)

@dataclass(frozen=True)
class UdebStatic:
    """Static configuration shared by the kernel and its plain version."""

    n: int
    steps: int
    dt_sub: float
    dz: float
    dz_mix: float
    c_mix: float
    af_top: tuple
    af_bot: tuple
    af_diff: tuple
    relative_depth: tuple
    inv_dz_dzup: tuple
    f_l: tuple  # (2,) land fraction per hemisphere (of the half-globe)
    fg: tuple  # (fgno, fgnl, fgso, fgsl) global box fractions
    qfrac: tuple  # (4,) regional CO2 forcing fractions
    diffusivity_scale: float
    land_heat_enabled: bool


def static_from_component(comp, dt_year: float) -> UdebStatic:
    """The static bundle of a ClimateUDEB component for a step of
    ``dt_year`` years (mirror of the JAX package's
    ``_static_from_component`` plus its non-unit-step fold)."""
    from rscm_tpu_torch.magicc.climate.udeb import DIFFUSIVITY_CM2S_TO_M2YR

    n = int(comp.n_layers)
    dz = float(comp.layer_thickness)
    dz_mix = float(comp.mixed_layer_depth)
    dz1 = dz / 2.0
    idx = np.arange(1, n - 1)
    dz_up = np.where(idx == 1, dz1, dz)
    total_depth = dz_mix + (n - 1.0) * dz
    depths = dz_mix + np.arange(n - 1) * dz
    steps = int(comp.steps_per_year)
    dt_sub = 1.0 / steps
    if abs(dt_year * 1.0 / steps - dt_sub) > 1e-12:
        dt_sub = float(dt_year) / steps
    return UdebStatic(
        n=n,
        steps=steps,
        dt_sub=dt_sub,
        dz=dz,
        dz_mix=dz_mix,
        c_mix=float(comp.mixed_layer_heat_capacity()),
        af_top=tuple(np.asarray(comp.af_top).tolist()),
        af_bot=tuple(np.asarray(comp.af_bottom).tolist()),
        af_diff=tuple(np.asarray(comp.af_diff).tolist()),
        relative_depth=tuple((depths / total_depth).tolist()),
        inv_dz_dzup=tuple((1.0 / (dz * dz_up)).tolist()),
        f_l=(float(comp.nh_land_fraction) / 2.0, float(comp.sh_land_fraction) / 2.0),
        fg=tuple(float(v) for v in comp.global_box_fractions()),
        qfrac=tuple(np.asarray(comp.co2_qfrac).tolist()),
        diffusivity_scale=DIFFUSIVITY_CM2S_TO_M2YR,
        land_heat_enabled=bool(comp.land_heat_capacity_enabled),
    )


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _month_plain(st: UdebStatic, scal, ocean, land, ground, hemi, upwell,
                 alpha_eff, init_prof, frac, tridiag="sequential", tape=None):
    """One monthly sub-step on ``(2, n, B)`` / ``(2, B)`` tensors
    (transcription of ``_month_body``); ``tridiag="assoc"`` solves the
    column by associative scans instead of the Thomas sweep.  A ``tape``
    dict receives the intermediates the adjoint twin reads
    (:func:`_month_vjp_plain`)."""
    n = st.n
    dz, dz_mix = st.dz, st.dz_mix
    dz1 = dz / 2.0
    dt_sub = st.dt_sub
    c_mix = st.c_mix
    fgno, fgnl, fgso, fgsl = st.fg
    f_l0, f_l1 = st.f_l
    q0, q1, q2, q3 = st.qfrac
    like = dict(dtype=ocean.dtype, device=ocean.device)

    def per_hemi(a, b):
        return torch.tensor([a, b], **like).view(2, 1)

    def per_layer(values):
        return torch.tensor(values, **like).view(1, -1, 1)

    f_l_c = per_hemi(f_l0, f_l1)
    f_o_c = per_hemi(0.5 - f_l0, 0.5 - f_l1)
    af_top = per_layer(st.af_top)
    af_bot = per_layer(st.af_bot)
    af_diff = per_layer(st.af_diff)
    sc = {name: scal[i] for i, name in enumerate(SCALAR_ROWS)}

    # efficacy scaling is folded into erf_start/erf_end by the caller
    erf = sc["erf_start"] + frac * (sc["erf_end"] - sc["erf_start"])

    # -- ground-heat damping ------------------------------------------------
    if st.land_heat_enabled:
        flux = sc["k_lg"] * (land - ground)
        safe_fl = per_hemi(f_l0 if f_l0 >= 1e-15 else 1.0, f_l1 if f_l1 >= 1e-15 else 1.0)
        delta_ground = flux / (safe_fl * sc["c_ground"]) * dt_sub
        ground = ground + torch.where(f_l_c < 1e-15, torch.zeros_like(delta_ground), delta_ground)

    # -- implicit ocean column update (both hemispheres) --------------------
    w = upwell
    ocean_forcing = torch.stack([erf * q0, erf * q2])
    ocean0 = ocean[:, 0]
    dkdt_term = sc["kappa_dkdt"] * (ocean0 - ocean[:, n - 1])
    one_minus_rel = per_layer([1.0 - r for r in st.relative_depth])
    kappa_pre = (one_minus_rel * dkdt_term[:, None] + sc["kappa"]) * st.diffusivity_scale
    kappa = torch.maximum(kappa_pre, sc["kappa_min"])  # (2, n-1, B)

    denominator = f_o_c * (sc["k_lo"] + f_l_c * sc["lam_l"])
    term_feedback = alpha_eff / c_mix * (
        sc["lam_o"] + sc["lam_l"] * sc["k_lo"] * sc["amplify"] * f_l_c / denominator
    )
    term_diff0 = kappa[:, 0] / (dz_mix * dz1) * dt_sub
    term_upwell0 = w / dz_mix * dt_sub
    forcing_amp = 1.0 + sc["k_lo"] * f_l_c / denominator
    tul = w / dz * dt_sub  # (2, B)
    delta_w = w - sc["w_initial"]
    t_polar = sc["t_polar"]

    # row 0 (mixed layer)
    b0 = (
        1.0
        + term_feedback * dt_sub * st.af_top[0]
        + term_diff0 * st.af_bot[0]
        + term_upwell0 * sc["pi_ratio"] * st.af_bot[0]
    )
    c0 = -(term_diff0 + term_upwell0) * st.af_bot[0]
    d0 = ocean0 + (ocean_forcing * forcing_amp + hemi) / c_mix * dt_sub * st.af_top[0]
    if st.land_heat_enabled:
        d0 = d0 - sc["k_lg"] * (land - ground) / (c_mix * f_o_c) * dt_sub * st.af_top[0]
    d0 = d0 + dt_sub / dz_mix * delta_w * (init_prof[:, 1] - t_polar) * st.af_bot[0]

    # interior rows 1..n-2, vectorised over layers
    mid = slice(1, n - 1)
    t_diff_up = kappa[:, : n - 2] * per_layer(st.inv_dz_dzup) * dt_sub
    t_diff_down = kappa[:, 1:] / (dz * dz) * dt_sub
    tul_mid = tul[:, None]
    a_mid = -t_diff_up * af_top[:, mid]
    b_mid = (
        1.0
        + t_diff_up * af_top[:, mid]
        + t_diff_down * af_bot[:, mid]
        + tul_mid * af_top[:, mid]
    )
    c_mid = -(t_diff_down + tul_mid) * af_bot[:, mid]
    d_mid = ocean[:, mid] + (sc["pi_ratio"] * tul * ocean0)[:, None] * af_diff[:, mid]
    k_dw = (dt_sub / dz * delta_w)[:, None]
    d_mid = d_mid + k_dw * (init_prof[:, 2:] * af_bot[:, mid] - init_prof[:, mid] * af_top[:, mid])
    d_mid = d_mid + (dt_sub / dz * delta_w * t_polar)[:, None] * af_diff[:, mid]

    # last row
    term_diff_last = kappa[:, n - 2] / (dz * dz) * dt_sub
    a_last = -term_diff_last * st.af_top[n - 1]
    b_last = 1.0 + (term_diff_last + tul) * st.af_top[n - 1]
    d_last = ocean[:, n - 1] + sc["pi_ratio"] * tul * ocean0 * st.af_top[n - 1]
    d_last = d_last + dt_sub / dz * delta_w * (t_polar - init_prof[:, n - 1]) * st.af_top[n - 1]

    # -- Thomas sweep, layer by layer ----------------------------------------
    a_rows = [None, *a_mid.unbind(1), a_last]
    b_rows = [b0, *b_mid.unbind(1), b_last]
    c_rows = [c0, *c_mid.unbind(1)]
    d_rows = [d0, *d_mid.unbind(1), d_last]
    if tridiag == "assoc":
        zeros = torch.zeros_like(b0)
        solution = thomas_solve_assoc(*(
            torch.stack(rows, dim=-1)
            for rows in ([zeros, *a_rows[1:]], b_rows, [*c_rows, zeros], d_rows)
        )).movedim(-1, 1)  # (2, B, n) -> (2, n, B)
    else:
        c_prime = [c_rows[0] / b_rows[0]]
        d_prime = [d_rows[0] / b_rows[0]]
        for i in range(1, n):
            denom = b_rows[i] - a_rows[i] * c_prime[i - 1]
            if i < n - 1:
                c_prime.append(c_rows[i] / denom)
            d_prime.append((d_rows[i] - a_rows[i] * d_prime[i - 1]) / denom)
        x = [None] * n
        x[n - 1] = d_prime[n - 1]
        for i in range(n - 2, -1, -1):
            x[i] = d_prime[i] - c_prime[i] * x[i + 1]
        solution = torch.stack(x, dim=1)
        if tape is not None:
            tape.update(ground=ground, kappa_pre=kappa_pre, a=a_rows, b=b_rows, cp=c_prime,
                        dp=d_prime, x=x)
    ocean = torch.minimum(solution, sc["max_temp"])

    # -- land / exchange / upwelling ----------------------------------------
    alpha, gamma = sc["adj_alpha"], sc["adj_gamma"]
    nonzero = gamma.abs() > 1e-15
    gamma_safe = torch.where(nonzero, gamma, torch.ones_like(gamma))
    t_star = -(alpha - 1.0) / (2.0 * gamma_safe)
    delta_max = alpha * t_star + gamma * t_star * t_star - t_star

    def sst_to_air(sst):
        quad = torch.where(sst < t_star, alpha * sst + gamma * sst * sst, sst + delta_max)
        return torch.where(nonzero, quad, alpha * sst)

    t_air_nho = sst_to_air(ocean[0, 0])
    t_air_sho = sst_to_air(ocean[1, 0])
    land = torch.stack([
        torch.minimum(
            (erf * q1 * fgnl + sc["k_lo"] * sc["amplify"] * t_air_nho)
            / (sc["lam_l"] * fgnl + sc["k_lo"]),
            sc["max_temp"],
        ),
        torch.minimum(
            (erf * q3 * fgsl + sc["k_lo"] * sc["amplify"] * t_air_sho)
            / (sc["lam_l"] * fgsl + sc["k_lo"]),
            sc["max_temp"],
        ),
    ])
    exchange_nh = sc["k_ns"] / fgno * (t_air_sho - t_air_nho) if fgno > 1e-15 else hemi[0]
    exchange_sh = sc["k_ns"] / fgso * (t_air_nho - t_air_sho) if fgso > 1e-15 else hemi[1]
    hemi = torch.stack([exchange_nh, exchange_sh])

    global_temp = t_air_nho * fgno + land[0] * fgnl + t_air_sho * fgso + land[1] * fgsl
    w_thresh = scal[S : S + 2]
    w_min = sc["w_initial"] * (1.0 - sc["w_var_frac"])
    ratios = torch.minimum(global_temp / w_thresh, torch.ones_like(w_thresh))
    upwell = torch.maximum(sc["w_initial"] * (1.0 - sc["w_var_frac"] * ratios), w_min)
    if tape is not None:
        tape.update(erf=erf, t_star=t_star, delta_max=delta_max, nonzero=nonzero,
                    t_air=torch.stack([t_air_nho, t_air_sho]), global_temp=global_temp)
    return ocean, land, ground, hemi, upwell


def udeb_year_plain(st: UdebStatic, scal, ocean, init_prof, vec, tridiag="sequential"):
    """Plain PyTorch version of the kernel on the member-minor layout
    (twin of the JAX package's ``_months_jnp``).  ``tridiag`` is
    ClimateUDEB's ``tridiag_solver``: ``"sequential"`` (the Thomas sweep
    the kernel runs) or ``"assoc"`` (:func:`~rscm_tpu_torch.utils.
    linear_algebra.thomas_solve_assoc`)."""
    if tridiag not in ("sequential", "assoc"):
        raise ValueError(f"tridiag_solver must be 'sequential' or 'assoc', not {tridiag!r}")
    n, b = st.n, ocean.shape[-1]
    ocean = ocean.reshape(2, n, b)
    init_prof = init_prof.reshape(2, n, -1)
    land, ground, hemi, upwell, alpha_eff = (vec[k : k + 2] for k in range(0, 10, 2))
    for m in range(1, st.steps + 1):
        ocean, land, ground, hemi, upwell = _month_plain(
            st, scal, ocean, land, ground, hemi, upwell, alpha_eff, init_prof, m / st.steps,
            tridiag,
        )
    return ocean.reshape(2 * n, b), torch.cat([land, ground, hemi, upwell])


# ---------------------------------------------------------------------------
# the adjoint's plain version
# ---------------------------------------------------------------------------


def _max_bar(a, b, g):
    """Cotangents of ``torch.maximum(a, b)`` from ``g``: a tie sends half to
    each operand, as PyTorch's and JAX's rules do."""
    half = g * 0.5
    zero = torch.zeros_like(g)
    return (torch.where(a == b, half, torch.where(a > b, g, zero)),
            torch.where(a == b, half, torch.where(a > b, zero, g)))


def _min_bar(a, b, g):
    """Cotangents of ``torch.minimum(a, b)`` from ``g`` (ties halved)."""
    half = g * 0.5
    zero = torch.zeros_like(g)
    return (torch.where(a == b, half, torch.where(a < b, g, zero)),
            torch.where(a == b, half, torch.where(a < b, zero, g)))


def _month_vjp_plain(st: UdebStatic, scal, state, alpha_eff, init_prof, frac, bars, acc, tp):
    """The adjoint of one month (the kernel's ``month_vjp``, same operations
    in the same order) on ``(2, B)`` tensors, one row a hemisphere as one
    thread a hemisphere in the kernel: ``state`` is the month's starting
    ``(ocean (2, n, B), land, ground, hemi, upwell)``, ``tp`` the tape
    :func:`_month_plain` wrote when it ran the month from that state,
    ``bars`` the cotangents of its outputs ``(ocean rows [n x (2, B)],
    land, ground, hemi, upwell)``.  Returns the cotangents of its starting
    state;
    ``acc`` accumulates those of the constants: ``scal`` ``(S + 1, 2, B)``
    (the row ``S`` is each hemisphere's own upwelling threshold),
    ``alpha_eff``, ``prof`` (``[n x (2, B)]``) and ``delta_max`` (the SST->
    air map's constant, differentiated once a year)."""
    n = st.n
    dt = st.dt_sub
    fgno, fgnl, fgso, fgsl = st.fg
    f_l0, f_l1 = st.f_l
    like = dict(dtype=state[0].dtype, device=state[0].device)

    def per_hemi(a, b):
        return torch.tensor([a, b], **like).view(2, 1)

    f_l = per_hemi(f_l0, f_l1)
    f_o = per_hemi(0.5 - f_l0, 0.5 - f_l1)
    safe_fl = per_hemi(f_l0 if f_l0 >= 1e-15 else 1.0, f_l1 if f_l1 >= 1e-15 else 1.0)
    fl_ok = f_l >= 1e-15
    cmfo = st.c_mix * f_o
    q_ocean = per_hemi(st.qfrac[0], st.qfrac[2])
    q_land = per_hemi(st.qfrac[1], st.qfrac[3])
    fg_land = per_hemi(fgnl, fgsl)
    fg_own_o, fg_other_o = per_hemi(fgno, fgso), per_hemi(fgso, fgno)
    fg_own_l, fg_other_l = fg_land, per_hemi(fgsl, fgnl)
    exchange = per_hemi(float(fgno > 1e-15), float(fgso > 1e-15)) > 0.5
    # 1 / fg in the working dtype, as PyTorch's CUDA division by a host
    # scalar (and the kernel's constants) take it
    inv_fg_o = torch.where(exchange, 1.0 / per_hemi(fgno if fgno > 1e-15 else 1.0,
                                                    fgso if fgso > 1e-15 else 1.0), 0.0)
    at, ab, ad = st.af_top, st.af_bot, st.af_diff
    omr = [1.0 - r for r in st.relative_depth]
    I = {name: i for i, name in enumerate(SCALAR_ROWS)}
    sc = {name: scal[i] for i, name in enumerate(SCALAR_ROWS)}
    sb = acc["scal"]
    pb = acc["prof"]

    def add(name, v):
        sb[I[name]] = sb[I[name]] + v

    ocean, land, ground, hemi, upw = state
    col_bar, land_bar, ground_bar, hemi_bar, upw_bar = bars
    prof = [init_prof[:, i] for i in range(n)]
    cp, dp, x = tp["cp"], tp["dp"], tp["x"]
    mt = sc["max_temp"]
    w = upw
    t_polar = sc["t_polar"]
    ocean0, ocean_last = ocean[:, 0], ocean[:, n - 1]

    # -- land / exchange / upwelling ----------------------------------------
    w_initial, w_var = sc["w_initial"], sc["w_var_frac"]
    w_thresh = scal[S : S + 2]
    gt = tp["global_temp"]
    r0 = gt / w_thresh
    ratio = torch.minimum(r0, torch.ones_like(w_thresh))
    b2 = 1.0 - w_var * ratio
    w_min = w_initial * (1.0 - w_var)
    g_a, g_b = _max_bar(w_initial * b2, w_min, upw_bar)
    add("w_initial", g_a * b2)
    b2_bar = g_a * w_initial
    add("w_var_frac", -(b2_bar * ratio))
    ratio_bar = -(b2_bar * w_var)
    add("w_initial", g_b * (1.0 - w_var))
    add("w_var_frac", -(g_b * w_initial))
    r0_bar, _ = _min_bar(r0, torch.ones_like(r0), ratio_bar)
    gt_bar = r0_bar / w_thresh
    sb[S] = sb[S] - gt_bar * r0
    t_air = tp["t_air"]
    t_other = t_air.flip(0)
    t_own_bar = gt_bar * fg_own_o
    t_other_bar = gt_bar * fg_other_o
    land_own_bar = gt_bar * fg_own_l
    land_other_bar = gt_bar * fg_other_l
    zero = torch.zeros_like(hemi_bar)
    dif = t_other - t_air
    e = sc["k_ns"] * inv_fg_o
    add("k_ns", torch.where(exchange, (hemi_bar * dif) * inv_fg_o, zero))
    dif_bar = torch.where(exchange, hemi_bar * e, zero)
    t_other_bar = t_other_bar + dif_bar
    t_own_bar = t_own_bar - dif_bar
    hemi_in_bar = torch.where(exchange, zero, hemi_bar)

    land_bar = (land_bar + land_own_bar) + land_other_bar.flip(0)
    erf = tp["erf"]
    ka = sc["k_lo"] * sc["amplify"]
    num = (erf * q_land) * fg_land + ka * t_air
    den = sc["lam_l"] * fg_land + sc["k_lo"]
    land_pre = num / den
    g_l, g_mt = _min_bar(land_pre, mt, land_bar)
    add("max_temp", g_mt)
    num_bar = g_l / den
    den_bar = -(num_bar * land_pre)
    add("lam_l", den_bar * fg_land)
    add("k_lo", den_bar)
    erf_bar = (num_bar * fg_land) * q_land
    ka_bar = num_bar * t_air
    add("k_lo", ka_bar * sc["amplify"])
    add("amplify", ka_bar * sc["k_lo"])
    t_own_bar = t_own_bar + num_bar * ka
    t_bar = t_own_bar + t_other_bar.flip(0)

    # SST -> air: the branch the forward took
    alpha, gamma = sc["adj_alpha"], sc["adj_gamma"]
    nonzero = tp["nonzero"]
    sst = torch.minimum(x[0], mt)
    lower = sst < tp["t_star"]
    linear = ~nonzero | lower  # alpha * sst appears
    add("adj_alpha", torch.where(linear, t_bar * sst, zero))
    gs = gamma * sst
    gs_bar = t_bar * sst
    add("adj_gamma", torch.where(nonzero & lower, gs_bar * sst, zero))
    sst_bar = torch.where(
        nonzero, torch.where(lower, (t_bar * alpha + t_bar * gs) + gs_bar * gamma, t_bar),
        t_bar * alpha)
    acc["delta_max"] = acc["delta_max"] + torch.where(nonzero & ~lower, t_bar, zero)

    # -- the clamp and back substitution -------------------------------------
    # (a sum over the rows is taken within the month, then added to the
    # year's: one running sum over every row of the year rounds far more in
    # float32)
    xb = [None] * n
    mt_sum = zero
    for i in range(n):
        g = col_bar[i] + sst_bar if i == 0 else col_bar[i]
        g_x, g_mt = _min_bar(x[i], mt, g)
        mt_sum = mt_sum + g_mt
        xb[i] = g_x if i == 0 else g_x - xb[i - 1] * cp[i - 1]
    add("max_temp", mt_sum)

    # -- the forward sweep and the assembly, last row first ------------------
    col_in = [None] * n
    tul = w / st.dz * dt
    delta_w = w - w_initial
    k_dw = st.dt_sub / st.dz * delta_w
    dkdt_bar = zero
    tul_bar = zero
    pto_bar = zero
    k_dw_bar = zero
    k_dw_tp_bar = zero
    kappa_sum = zero
    kmin_sum = zero

    def kappa_bar_add(i, kb):
        nonlocal dkdt_bar, kappa_sum, kmin_sum
        g_k, g_min = _max_bar(tp["kappa_pre"][:, i], sc["kappa_min"], kb)
        kmin_sum = kmin_sum + g_min
        kp_bar = g_k * st.diffusivity_scale
        kappa_sum = kappa_sum + kp_bar
        dkdt_bar = dkdt_bar + kp_bar * omr[i]

    i = n - 1
    a_l, b_l = tp["a"][i], tp["b"][i]
    den = b_l - a_l * cp[i - 1]
    num_bar = xb[i] / den
    den_bar = -(num_bar * x[i])
    d_bar = num_bar
    a_bar = -(num_bar * dp[i - 1])
    pend_dp = -(num_bar * a_l)
    b_bar = den_bar
    a_bar = a_bar - den_bar * cp[i - 1]
    pend_cp = -(den_bar * a_l)
    col_in[i] = d_bar
    pto_bar = pto_bar + d_bar * at[i]
    kq_bar = d_bar * at[i]
    k_dw_bar = k_dw_bar + kq_bar * (t_polar - prof[i])
    pq_bar = kq_bar * k_dw
    add("t_polar", pq_bar)
    pb[i] = pb[i] - pq_bar
    s_bar = b_bar * at[i]
    tdl_bar = s_bar - a_bar * at[i]
    tul_bar = tul_bar + s_bar
    kappa_carry = (tdl_bar * dt) / (st.dz * st.dz)
    for i in range(n - 2, 0, -1):
        a_i, b_i = tp["a"][i], tp["b"][i]
        den = b_i - a_i * cp[i - 1]
        dp_bar = xb[i] + pend_dp
        cp_bar = pend_cp - xb[i] * x[i + 1]
        num_bar = dp_bar / den
        den_bar = -(num_bar * dp[i])
        d_bar = num_bar
        a_bar = -(num_bar * dp[i - 1])
        pend_dp = -(num_bar * a_i)
        c_bar = cp_bar / den
        den_bar = den_bar - c_bar * cp[i]
        b_bar = den_bar
        a_bar = a_bar - den_bar * cp[i - 1]
        pend_cp = -(den_bar * a_i)
        col_in[i] = d_bar
        pto_bar = pto_bar + d_bar * ad[i]
        dif = prof[i + 1] * ab[i] - prof[i] * at[i]
        k_dw_bar = k_dw_bar + d_bar * dif
        dif_bar = d_bar * k_dw
        pb[i + 1] = pb[i + 1] + dif_bar * ab[i]
        pb[i] = pb[i] - dif_bar * at[i]
        k_dw_tp_bar = k_dw_tp_bar + d_bar * ad[i]
        s_bar = -(c_bar * ab[i])
        tdd_bar = s_bar + b_bar * ab[i]
        tul_bar = tul_bar + s_bar
        tul_bar = tul_bar + b_bar * at[i]
        tdu_bar = b_bar * at[i] - a_bar * at[i]
        kappa_bar_add(i, kappa_carry + (tdd_bar * dt) / (st.dz * st.dz))
        kappa_carry = (tdu_bar * dt) * st.inv_dz_dzup[i - 1]

    # row 0
    b0 = tp["b"][0]
    dp_bar = xb[0] + pend_dp
    cp_bar = pend_cp - xb[0] * x[1]
    d0_bar = dp_bar / b0
    b0_bar = -(d0_bar * dp[0])
    c0_bar = cp_bar / b0
    b0_bar = b0_bar - c0_bar * cp[0]
    col_in[0] = d0_bar
    kb_bar = d0_bar * ab[0]
    pp = prof[1] - t_polar
    ka0 = st.dt_sub / st.dz_mix * delta_w
    ka0_bar = kb_bar * pp
    pp_bar = kb_bar * ka0
    pb[1] = pb[1] + pp_bar
    add("t_polar", -pp_bar)
    delta_w_bar = ka0_bar * (st.dt_sub / st.dz_mix)
    land_in_bar = zero
    ground1_bar = ground_bar
    if st.land_heat_enabled:
        lg2 = land - tp["ground"]
        ga_bar = ((-d0_bar * at[0]) * dt) / cmfo
        add("k_lg", ga_bar * lg2)
        lg2_bar = ga_bar * sc["k_lg"]
        land_in_bar = lg2_bar
        ground1_bar = ground1_bar - lg2_bar
    denom_fb = f_o * (sc["k_lo"] + f_l * sc["lam_l"])
    p6 = sc["k_lo"] * f_l / denom_fb
    forcing_amp = 1.0 + p6
    fa = erf * q_ocean
    fc_bar = ((d0_bar * at[0]) * dt) / st.c_mix
    hemi_in_bar = hemi_in_bar + fc_bar
    fa_bar = fc_bar * forcing_amp
    famp_bar = fc_bar * fa
    erf_bar = erf_bar + fa_bar * q_ocean
    s_bar = -(c0_bar * ab[0])
    td0_bar = s_bar
    tu0_bar = s_bar
    tf_bar = (b0_bar * at[0]) * dt
    td0_bar = td0_bar + b0_bar * ab[0]
    tup_bar = b0_bar * ab[0]
    tu0 = w / st.dz_mix * dt
    tu0_bar = tu0_bar + tup_bar * sc["pi_ratio"]
    add("pi_ratio", tup_bar * tu0)
    kappa_bar_add(0, kappa_carry + (td0_bar * dt) / (st.dz_mix * (st.dz / 2.0)))
    w_bar = (tu0_bar * dt) / st.dz_mix

    # the row constants
    k_dw_bar = k_dw_bar + k_dw_tp_bar * t_polar
    add("t_polar", k_dw_tp_bar * k_dw)
    delta_w_bar = delta_w_bar + k_dw_bar * (st.dt_sub / st.dz)
    pt = sc["pi_ratio"] * tul
    pt_bar = pto_bar * ocean0
    col_in[0] = col_in[0] + pto_bar * pt
    add("pi_ratio", pt_bar * tul)
    tul_bar = tul_bar + pt_bar * sc["pi_ratio"]
    w_bar = w_bar + delta_w_bar
    add("w_initial", -delta_w_bar)
    w_bar = w_bar + (tul_bar * dt) / st.dz
    p5_bar = famp_bar / denom_fb
    dfb_bar = -(p5_bar * p6)
    add("k_lo", p5_bar * f_l)
    p1 = sc["lam_l"] * sc["k_lo"]
    p2 = p1 * sc["amplify"]
    p4 = p2 * f_l / denom_fb
    ae = alpha_eff / st.c_mix
    ae_bar = tf_bar * (sc["lam_o"] + p4)
    acc["alpha_eff"] = acc["alpha_eff"] + ae_bar / st.c_mix
    s2_bar = tf_bar * ae
    add("lam_o", s2_bar)
    p3_bar = s2_bar / denom_fb
    dfb_bar = dfb_bar - p3_bar * p4
    p2_bar = p3_bar * f_l
    p1_bar = p2_bar * sc["amplify"]
    add("amplify", p2_bar * p1)
    add("lam_l", p1_bar * sc["k_lo"])
    add("k_lo", p1_bar * sc["lam_l"])
    s1_bar = dfb_bar * f_o
    add("k_lo", s1_bar)
    add("lam_l", s1_bar * f_l)
    add("kappa_min", kmin_sum)
    add("kappa", kappa_sum)
    dd = ocean0 - ocean_last
    add("kappa_dkdt", dkdt_bar * dd)
    dd_bar = dkdt_bar * sc["kappa_dkdt"]
    col_in[0] = col_in[0] + dd_bar
    col_in[n - 1] = col_in[n - 1] - dd_bar

    # -- ground-heat damping, and the month's forcing ------------------------
    ground_in_bar = ground1_bar
    if st.land_heat_enabled:
        lmg = land - ground
        flux = sc["k_lg"] * lmg
        den_g = safe_fl * sc["c_ground"]
        u_g = flux / den_g
        flux_bar = torch.where(fl_ok, ground1_bar * dt, zero) / den_g
        add("c_ground", -(flux_bar * u_g) * safe_fl)
        add("k_lg", flux_bar * lmg)
        lmg_bar = flux_bar * sc["k_lg"]
        land_in_bar = land_in_bar + lmg_bar
        ground_in_bar = ground_in_bar - lmg_bar
    add("erf_start", erf_bar)
    fr_bar = erf_bar * frac
    add("erf_end", fr_bar)
    add("erf_start", -fr_bar)
    return col_in, land_in_bar, ground_in_bar, hemi_in_bar, w_bar


def udeb_year_vjp_plain(st: UdebStatic, scal, ocean, init_prof, vec, g_ocean, g_vec):
    """Plain PyTorch version of the adjoint kernel (``udeb_year_vjp_kernel``,
    its operations in its order): the cotangents ``(scal (S + 2, B), ocean
    (2 n, B), init_prof (2 n, B) dense, vec (10, B))`` of one year's inputs
    from those of its outputs, ``g_ocean`` ``(2 n, B)`` and ``g_vec``
    ``(8, B)`` (``None`` reads as zero).

    It runs the year's forward once (:func:`_month_plain`), keeping each
    month's starting state and its tape (the Thomas factors, the unclamped
    solution and the values the adjoint reads), then takes the months'
    adjoints from the twelfth to the first (:func:`_month_vjp_plain`) on
    those tapes, with no month run again: the transposed Thomas solve, the
    assembly and the coupling step, every ``where`` sending its cotangent to
    the branch the forward took and every ``minimum`` / ``maximum`` half of
    it to each operand at a tie.
    """
    n, b = st.n, ocean.shape[-1]
    like = dict(dtype=ocean.dtype, device=ocean.device)
    init_prof = init_prof.reshape(2, n, -1).expand(2, n, b)
    vec_pairs = [vec[k : k + 2] for k in range(0, 10, 2)]
    alpha_eff = vec_pairs[4]
    with torch.no_grad():
        state = (ocean.reshape(2, n, b), *vec_pairs[:4])
        states, tapes = [], []
        for m in range(1, st.steps + 1):
            states.append(state)
            tapes.append({})
            state = _month_plain(st, scal, *state[:5], alpha_eff, init_prof, m / st.steps,
                                 tape=tapes[-1])
        g_ocean = torch.zeros((2 * n, b), **like) if g_ocean is None else g_ocean
        g_vec = torch.zeros((8, b), **like) if g_vec is None else g_vec
        zero = torch.zeros((2, b), **like)
        bars = (list(g_ocean.reshape(2, n, b).unbind(1)),
                *(g_vec[k : k + 2] for k in range(0, 8, 2)))
        acc = {"scal": [zero] * (S + 1), "prof": [zero] * n, "alpha_eff": zero,
               "delta_max": zero}
        for m in range(st.steps, 0, -1):
            bars = _month_vjp_plain(st, scal, states[m - 1], alpha_eff, init_prof,
                                    m / st.steps, bars, acc, tapes[m - 1])

        # the SST->air map's constants, once a year
        sb = acc["scal"]
        ia, ig = SCALAR_ROWS.index("adj_alpha"), SCALAR_ROWS.index("adj_gamma")
        alpha, gamma = scal[ia], scal[ig]
        nonzero = gamma.abs() > 1e-15
        gamma_safe = torch.where(nonzero, gamma, torch.ones_like(gamma))
        t_star = -(alpha - 1.0) / (2.0 * gamma_safe)
        dm_bar = acc["delta_max"]
        sb[ia] = sb[ia] + dm_bar * t_star
        ts_bar = dm_bar * alpha
        gts_bar = dm_bar * t_star
        ts_bar = ts_bar + dm_bar * (gamma * t_star)
        sb[ig] = sb[ig] + gts_bar * t_star
        ts_bar = ts_bar + gts_bar * gamma
        ts_bar = ts_bar - dm_bar
        nm_bar = ts_bar / (2.0 * gamma_safe)
        sb[ia] = sb[ia] - nm_bar
        sb[ig] = sb[ig] + torch.where(nonzero, -(nm_bar * t_star) * 2.0, zero)

        g_scal = torch.cat([torch.stack([v[0] + v[1] for v in sb[:S]]), sb[S]])
        col_in, *vec_bars = bars
        g_ocean_in = torch.stack(col_in, dim=1).reshape(2 * n, b)
        g_init = torch.stack(acc["prof"], dim=1).reshape(2 * n, b)
        g_vec_in = torch.cat([*vec_bars, acc["alpha_eff"]])
    return g_scal, g_ocean_in, g_init, g_vec_in


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

#: order of the leading constants in the kernel's geometry struct
#: (``csrc/udeb_year.cu``, ``enum GeomIndex``)
_GEOM_SCALARS = (
    "dt_sub", "inv_c_mix", "inv_dzmix_dz1", "inv_dz_mix", "inv_dz", "inv_dz2",
    "k_dt_dzmix", "k_dt_dz", "dscale",
    "f_l0", "f_l1", "f_o0", "f_o1", "safe_fl0", "safe_fl1", "cmfo0", "cmfo1",
    "q0", "q1", "q2", "q3", "fgno", "fgnl", "fgso", "fgsl", "inv_fgno", "inv_fgso",
)


def _geom(st: UdebStatic, np_dtype):
    """The kernel's geometry in the working dtype: the leading constants
    (passed by value) and the per-layer rows ``af_top``, ``af_bot``,
    ``af_diff``, ``one_minus_rel``, ``inv_dz_dzup`` (one device buffer).

    Each constant is what the plain version's PyTorch op uses on the card:
    a host float rounded to the dtype, a reciprocal taken in the dtype
    where PyTorch divides by a host scalar, a product of two rounded
    operands where the plain version multiplies two constant tensors.
    """
    t = np_dtype.type
    one = t(1.0)
    dz, dz_mix, c_mix = st.dz, st.dz_mix, st.c_mix
    f_l0, f_l1 = st.f_l
    fgno, fgnl, fgso, fgsl = st.fg
    vals = {
        "dt_sub": t(st.dt_sub),
        "inv_c_mix": one / t(c_mix),
        "inv_dzmix_dz1": one / t(dz_mix * (dz / 2.0)),
        "inv_dz_mix": one / t(dz_mix),
        "inv_dz": one / t(dz),
        "inv_dz2": one / t(dz * dz),
        "k_dt_dzmix": t(st.dt_sub / dz_mix),
        "k_dt_dz": t(st.dt_sub / dz),
        "dscale": t(st.diffusivity_scale),
        "f_l0": t(f_l0),
        "f_l1": t(f_l1),
        "f_o0": t(0.5 - f_l0),
        "f_o1": t(0.5 - f_l1),
        "safe_fl0": t(f_l0 if f_l0 >= 1e-15 else 1.0),
        "safe_fl1": t(f_l1 if f_l1 >= 1e-15 else 1.0),
        "cmfo0": t(0.5 - f_l0) * t(c_mix),
        "cmfo1": t(0.5 - f_l1) * t(c_mix),
        "q0": t(st.qfrac[0]),
        "q1": t(st.qfrac[1]),
        "q2": t(st.qfrac[2]),
        "q3": t(st.qfrac[3]),
        "fgno": t(fgno),
        "fgnl": t(fgnl),
        "fgso": t(fgso),
        "fgsl": t(fgsl),
        "inv_fgno": one / t(fgno) if fgno > 1e-15 else t(0.0),
        "inv_fgso": one / t(fgso) if fgso > 1e-15 else t(0.0),
    }
    consts = np.asarray([vals[k] for k in _GEOM_SCALARS], dtype=np_dtype)
    layers = np.concatenate([
        np.asarray(st.af_top, dtype=np_dtype),
        np.asarray(st.af_bot, dtype=np_dtype),
        np.asarray(st.af_diff, dtype=np_dtype),
        np.asarray([1.0 - r for r in st.relative_depth], dtype=np_dtype),
        np.asarray(st.inv_dz_dzup, dtype=np_dtype),
    ])
    return consts, layers


#: ``(static, dtype, device) -> (constants, per-layer device buffer)``, most
#: recently used last: built once per configuration, so that a year's launch
#: adds no host-to-device copy; the oldest is dropped beyond _GEOM_CACHE_SIZE
_GEOM_CACHE = OrderedDict()
_GEOM_CACHE_SIZE = 16


def _kernel_geom(st: UdebStatic, dtype, device):
    key = (st, dtype, device)
    hit = _GEOM_CACHE.pop(key, None)
    if hit is None:
        consts, layers = _geom(st, np.dtype(np.float32 if dtype == torch.float32 else np.float64))
        hit = (consts, torch.tensor(layers, dtype=dtype, device=device))
        while len(_GEOM_CACHE) >= _GEOM_CACHE_SIZE:
            _GEOM_CACHE.popitem(last=False)
    _GEOM_CACHE[key] = hit
    return hit


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

#: the kernels of ``csrc/udeb_year.cu``: name -> the ``kind`` its launch
#: configuration is queried by (``udeb_year_config_*``)
_KINDS = {"udeb_year": 0, "udeb_year_jvp": 1, "udeb_year_vjp": 2}


def _check(st: UdebStatic, scal, ocean, init_prof, vec):
    n = st.n
    b = ocean.shape[-1]
    tensors = {"scal": scal, "ocean": ocean, "init_prof": init_prof, "vec": vec}
    for name, x in tensors.items():
        if x.device != ocean.device or x.dtype != ocean.dtype:
            raise ValueError(f"udeb_year: {name} must be on {ocean.device} as {ocean.dtype}")
        if x.dim() != 2 or x.shape[-1] != b:
            raise ValueError(f"udeb_year: {name} must be (rows, {b}), got {tuple(x.shape)}")
    for name, x, rows in (("scal", scal, S + 2), ("ocean", ocean, 2 * n),
                          ("init_prof", init_prof, 2 * n), ("vec", vec, 10)):
        if x.shape[0] != rows:
            raise ValueError(f"udeb_year: {name} must have {rows} rows, got {x.shape[0]}")


def _check_layers(n: int, dtype, kernel: str = "udeb_year"):
    limit = max_kernel_layers(dtype, kernel)
    if n > limit:
        raise ValueError(
            f"{kernel}: the CUDA kernel takes at most {limit} layers in {dtype}, not {n}: "
            f"a block of one warp keeps {n} layers per thread in shared memory, more than "
            f"a block may use"
        )


def _check_kernel_inputs(kernel: str, st: UdebStatic, dtype, **tensors):
    """What every kernel of the file needs of CUDA tensors; raises on the rest."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{kernel}: the kernel takes float32 or float64, not {dtype}")
    _check_layers(st.n, dtype, kernel)
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def _lib_fn(name: str, argtypes):
    from . import build

    fn = getattr(build.load("udeb_year"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(kernel: str, suffix: str, argtypes, device, *args):
    """Launch ``<kernel>_<suffix>`` on ``device``'s current stream (the
    stream handle goes last); raises with the CUDA error it returns."""
    fn = _lib_fn(f"{kernel}_{suffix}", [*argtypes, ctypes.c_void_p])
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error {err}")


@functools.lru_cache(maxsize=None)
def max_kernel_layers(dtype, kernel: str = "udeb_year") -> int:
    """The most layers ``kernel`` (``udeb_year``, ``udeb_year_jvp`` or
    ``udeb_year_vjp``) takes in ``dtype``, as the kernel's library states it
    (``csrc/udeb_year.cu``, ``max_layers``): a block of one warp must fit
    the shared memory a block may use.  409 / 818 layers (float64 /
    float32) for the forward, 394 / 792 for the tangent kernel, 403 / 813
    for the adjoint; ``udeb_year_jvp_shared`` gives the most, 212 / 424, at
    which the tangent kernel may keep its c' in shared memory
    (:func:`kernel_config`).  Builds the kernels on first use."""
    return int(_lib_fn(f"{kernel}_max_layers_{_SUFFIX[dtype]}", [])())


def kernel_config(n: int, dtype, device=None, kernel: str = "udeb_year", b: int = 0,
                  steps: int = 12) -> dict:
    """``kernel``'s launch configuration at ``n`` layers on the current (or
    given) card, as its library states it (``udeb_year_config_*``):
    threads per block, resident blocks per SM (from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), shared bytes per
    block and ``scratch``, the values of the device buffer a launch of
    ``b`` members and ``steps`` months needs.  For the tangent kernel with
    ``b`` given, the configuration of the layout the library picks for
    ``b`` members: its c' in shared memory (no scratch) while one wave of
    that layout holds the batch, else in the scratch.  Raises above
    :func:`max_kernel_layers`."""
    _check_layers(n, dtype, kernel)
    p, ll = ctypes.POINTER, ctypes.c_longlong
    fn = _lib_fn(f"udeb_year_config_{_SUFFIX[dtype]}",
                 [ctypes.c_int, ctypes.c_int, ctypes.c_int, ll, p(ctypes.c_int),
                  p(ctypes.c_int), p(ll), p(ll)])
    threads, blocks, smem, scratch = ctypes.c_int(), ctypes.c_int(), ll(), ll()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = fn(_KINDS[kernel], n, steps, b, ctypes.byref(threads), ctypes.byref(blocks),
                 ctypes.byref(smem), ctypes.byref(scratch))
    if err != 0:
        raise RuntimeError(f"{kernel}: no launch configuration at {n} layers (CUDA error {err})")
    return {"threads": threads.value, "blocks_per_sm": blocks.value, "shared_bytes": smem.value,
            "scratch": scratch.value}


def _scratch(kernel: str, st: UdebStatic, b: int, like: dict):
    """The device scratch a launch of ``kernel`` on ``b`` members needs, at
    the length its library states (:func:`kernel_config`)."""
    c = kernel_config(st.n, like["dtype"], like["device"], kernel, b=b, steps=st.steps)
    return torch.empty(c["scratch"], **like)


def udeb_year(st: UdebStatic, scal, ocean, init_prof, vec):
    """One year of monthly sub-steps for every member.

    CPU tensors take :func:`udeb_year_plain`, at any layer count, and
    autograd goes through it.  CUDA tensors launch the kernel (built on
    first use) at any layer count up to :func:`max_kernel_layers`, through
    :class:`UdebYearFunction`, whose derivatives in both modes are kernels
    too; anything a kernel cannot take raises.
    """
    _check(st, scal, ocean, init_prof, vec)
    if ocean.device.type == "cpu":
        return udeb_year_plain(st, scal, ocean, init_prof, vec)
    if ocean.device.type != "cuda":
        raise ValueError(f"udeb_year: no kernel for device {ocean.device}")
    return UdebYearFunction.apply(st, scal, ocean, init_prof, vec)


class UdebYearFunction(torch.autograd.Function):
    """The kernel and its derivative kernels.

    The JAX package wraps its Pallas kernel in a ``custom_jvp`` whose rule
    differentiates the kernel's ``jnp`` reference (``_year_jvp``,
    ``rscm_tpu/ops/udeb_month.py:542-546``).  Here ``forward`` launches the
    CUDA kernel (:func:`_udeb_year_forward`), ``jvp`` the tangent kernel
    (:func:`udeb_year_jvp`) and ``backward`` the adjoint kernel
    (:func:`udeb_year_vjp`), each on the saved inputs.  On CPU tensors, as
    the tests call it, they take the plain versions: the forward without a
    tape, ``plain_jvp`` of :func:`udeb_year_plain`, and the explicit adjoint
    :func:`udeb_year_vjp_plain`.
    """

    @staticmethod
    def forward(st, scal, ocean, init_prof, vec):
        return _udeb_year_forward(st, scal, ocean, init_prof, vec)

    @staticmethod
    def setup_context(ctx, inputs, output):
        st, *tensors = inputs
        ctx.st = st
        ctx.save_for_backward(*tensors)
        ctx.save_for_forward(*tensors)

    @staticmethod
    def backward(ctx, g_ocean, g_vec):
        return (None, *udeb_year_vjp(ctx.st, *ctx.saved_tensors, g_ocean, g_vec,
                                     needs=ctx.needs_input_grad[1:]))

    @staticmethod
    def jvp(ctx, _st_t, *tangents):
        return udeb_year_jvp(ctx.st, ctx.saved_tensors, tangents)


def _udeb_year_forward(st: UdebStatic, scal, ocean, init_prof, vec):
    """One launch of the kernel (the plain version on CPU tensors)."""
    if ocean.device.type == "cpu":
        with torch.no_grad():
            return udeb_year_plain(st, scal, ocean, init_prof, vec)
    return _udeb_year_launch(st, scal, ocean, init_prof, vec)


def _udeb_year_launch(st: UdebStatic, scal, ocean, init_prof, vec):
    _check_kernel_inputs("udeb_year", st, ocean.dtype, scal=scal, ocean=ocean, vec=vec)
    b = ocean.shape[-1]
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    consts, layers = _kernel_geom(st, ocean.dtype, ocean.device)
    ocean_out = torch.empty_like(ocean)
    vec_out = torch.empty((8, b), dtype=ocean.dtype, device=ocean.device)
    _launch("udeb_year", _SUFFIX[ocean.dtype],
            [p, i, i, i, i, p, p, p, p, ll, ll, p, p, p, ll], ocean.device,
            consts.ctypes.data, consts.size, st.n, st.steps, int(st.land_heat_enabled),
            layers.data_ptr(), scal.data_ptr(), ocean.data_ptr(), init_prof.data_ptr(),
            init_prof.stride(0), init_prof.stride(1),
            vec.data_ptr(), ocean_out.data_ptr(), vec_out.data_ptr(), b)
    udeb_year.launches += 1
    note_launch("udeb_year", udeb_year_work, st, scal, ocean, init_prof, vec)
    return ocean_out, vec_out


def udeb_year_jvp(st: UdebStatic, primals, tangents):
    """The tangents ``(ocean (2 n, B), vec (8, B))`` of one year's outputs
    from those of its inputs ``(scal, ocean, init_prof, vec)`` (a missing
    tangent is zero), at ``primals``.

    CPU tensors take ``plain_jvp`` of :func:`udeb_year_plain`.  CUDA
    tensors launch the tangent kernel (``udeb_year_jvp_kernel``,
    ``csrc/udeb_year.cu``), which replaces the JAX package's rule
    ``_year_jvp`` (``rscm_tpu/ops/udeb_month.py:542-546``, not a
    ``pallas_call``): the forward month on dual numbers, two threads a
    member.  *Bound:* operations at a large batch (~3x the forward's
    arithmetic); at a gradient's batch (1-512 members) the serial chain of
    each member's months.  *Design:* the forward's own month code, so the
    values are the forward's bit for bit and every branch decides on them;
    the dual column in shared memory, and the dual c' in one of two
    layouts.  For a batch larger than one wave of
    the second, c' goes to a device buffer (``(n - 1) x 2 B`` pairs from
    ``torch.empty``) that the back sweep reads through a small shared ring
    filled with ``cp.async`` ahead of it: per-thread shared memory about
    the forward's, so the occupancy (8 warps an SM in float64 at 50
    layers) and the layer limit (:func:`max_kernel_layers` of
    ``"udeb_year_jvp"``) are about the forward's too.  For a gradient's
    batch, which one wave holds whatever the occupancy, c' stays in shared
    memory, so that the back sweep waits on no device-memory round trip
    (fewer resident warps, 4 at 50 layers in float64, and 212 layers at
    most).  The kernel's library picks the layout and states the buffer's
    length (:func:`kernel_config`).  A broadcast initial profile and its
    tangent keep their strides.
    """
    if primals[1].device.type == "cpu":
        return plain_jvp(functools.partial(udeb_year_plain, st), primals, tangents)
    return _udeb_year_jvp_launch(st, primals, tangents)


def _udeb_year_jvp_launch(st: UdebStatic, primals, tangents):
    scal, ocean, init_prof, vec = primals
    _check(st, *primals)
    dense = [torch.zeros_like(x) if t is None else t.contiguous()
             for x, t in zip((scal, ocean, vec), (tangents[0], tangents[1], tangents[3]))]
    t_init = tangents[2]
    if t_init is None:  # a zero, staged like a broadcast profile
        t_init = torch.zeros((1, 1), dtype=ocean.dtype, device=ocean.device).expand_as(init_prof)
    _check_kernel_inputs("udeb_year_jvp", st, ocean.dtype, scal=scal, ocean=ocean, vec=vec,
                         t_scal=dense[0], t_ocean=dense[1], t_vec=dense[2])
    b = ocean.shape[-1]
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    consts, layers = _kernel_geom(st, ocean.dtype, ocean.device)
    t_ocean_out = torch.empty_like(ocean)
    t_vec_out = torch.empty((8, b), dtype=ocean.dtype, device=ocean.device)
    # the ring layout's dual c' (none in the shared-memory layout)
    scratch = _scratch("udeb_year_jvp", st, b, dict(dtype=ocean.dtype, device=ocean.device))
    _launch("udeb_year_jvp", _SUFFIX[ocean.dtype],
            [p, i, i, i, i, p, p, p, p, p, p, ll, ll, p, ll, ll, p, p, p, p, p, ll, ll],
            ocean.device,
            consts.ctypes.data, consts.size, st.n, st.steps, int(st.land_heat_enabled),
            layers.data_ptr(), scal.data_ptr(), dense[0].data_ptr(), ocean.data_ptr(),
            dense[1].data_ptr(), init_prof.data_ptr(), init_prof.stride(0), init_prof.stride(1),
            t_init.data_ptr(), t_init.stride(0), t_init.stride(1), vec.data_ptr(),
            dense[2].data_ptr(), t_ocean_out.data_ptr(), t_vec_out.data_ptr(),
            scratch.data_ptr(), scratch.numel(), b)
    udeb_year_jvp.launches += 1
    note_launch("udeb_year_jvp", udeb_year_jvp_work, st, scal, ocean, init_prof, vec)
    return t_ocean_out, t_vec_out


def udeb_year_vjp(st: UdebStatic, scal, ocean, init_prof, vec, g_ocean, g_vec,
                  needs=(True, True, True, True)):
    """The cotangents ``(scal, ocean, init_prof, vec)`` of one year's
    inputs from those of its outputs (``None`` reads as zero), ``None``
    where ``needs`` is False.  ``init_prof``'s comes dense ``(2 n, B)``;
    autograd sums it back over a broadcast.

    CPU tensors take :func:`udeb_year_vjp_plain`.  CUDA tensors launch the
    adjoint kernel (``udeb_year_vjp_kernel``, ``csrc/udeb_year.cu``), which
    replaces the JAX package's rule ``_year_jvp`` transposed by JAX
    (``rscm_tpu/ops/udeb_month.py:542-546``, not a ``pallas_call``).
    *Bound:* operations at a large batch (the function needs ~2.4x the
    forward's arithmetic, one forward and the adjoint; the kernel performs
    about that, with the values its reverse pass recomputes); at a
    gradient's batch the serial chain of each member's months, forward
    then reverse.  *Design:* the forward's own month code runs the year
    once and writes a tape to device buffers from ``torch.empty``: every
    thread's unclamped solution, c' and d' of each column-month (``3 x
    steps x n`` values a thread, in L2 at a gradient's batch) and each
    month's starting scalars, so the adjoint differentiates at the
    forward's state bit for bit and runs no month again.  Each month's
    adjoint reads its tape back through a small shared ring filled with
    ``cp.async`` ahead of its two sweeps; shared memory holds only the
    column's and the profile's cotangents (the forward pass uses the same
    rows), so the occupancy and the layer limit are about the forward's.
    Two threads a member swap their cotangents with a warp shuffle; the
    scalar rows' cotangents accumulate in registers.
    """
    needs = tuple(needs)
    if ocean.device.type == "cpu":
        grads = udeb_year_vjp_plain(st, scal, ocean, init_prof, vec, g_ocean, g_vec)
    else:
        grads = _udeb_year_vjp_launch(st, scal, ocean, init_prof, vec, g_ocean, g_vec)
    return tuple(g if need else None for g, need in zip(grads, needs))


def _udeb_year_vjp_launch(st: UdebStatic, scal, ocean, init_prof, vec, g_ocean, g_vec):
    _check(st, scal, ocean, init_prof, vec)
    n, b = st.n, ocean.shape[-1]
    like = dict(dtype=ocean.dtype, device=ocean.device)
    g_ocean = torch.zeros((2 * n, b), **like) if g_ocean is None else g_ocean.contiguous()
    g_vec = torch.zeros((8, b), **like) if g_vec is None else g_vec.contiguous()
    _check_kernel_inputs("udeb_year_vjp", st, ocean.dtype, scal=scal, ocean=ocean, vec=vec,
                         g_ocean=g_ocean, g_vec=g_vec)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    consts, layers = _kernel_geom(st, ocean.dtype, ocean.device)
    grads = (torch.empty((S + 2, b), **like), torch.empty((2 * n, b), **like),
             torch.empty((2 * n, b), **like), torch.empty((10, b), **like))
    # the forward pass's tape: the unclamped solution, c' and d' of every
    # thread's column-month, and each month's starting scalars
    scratch = _scratch("udeb_year_vjp", st, b, like)
    _launch("udeb_year_vjp", _SUFFIX[ocean.dtype],
            [p, i, i, i, i, p, p, p, p, ll, ll, p, p, p, p, p, p, p, p, ll, ll], ocean.device,
            consts.ctypes.data, consts.size, n, st.steps, int(st.land_heat_enabled),
            layers.data_ptr(), scal.data_ptr(), ocean.data_ptr(), init_prof.data_ptr(),
            init_prof.stride(0), init_prof.stride(1), vec.data_ptr(), g_ocean.data_ptr(),
            g_vec.data_ptr(), *(g.data_ptr() for g in grads), scratch.data_ptr(),
            scratch.numel(), b)
    udeb_year_vjp.launches += 1
    note_launch("udeb_year_vjp", udeb_year_vjp_work, st, scal, ocean, init_prof, vec, g_ocean,
                g_vec)
    return grads


#: members of a launch whose plain version is counted for its work
_WORK_SAMPLE = 256


def _input_bytes(st: UdebStatic, scal, ocean, vec):
    """Bytes of one year's inputs read once: the scalar rows, the ocean, a
    profile (one column when it is broadcast, else every member's) and the
    vector state."""
    return scal.element_size() * (scal.numel() + ocean.numel() + 2 * st.n + vec.numel())


def _sampled(fn, st, b, *tensors, seeds=0):
    """``(other, divisions)`` of ``fn`` on the first members of a launch,
    which every member repeats, scaled to the batch ``b``; with ``seeds``,
    only the arithmetic that reads the last ``seeds`` tensors."""
    k = min(b, _WORK_SAMPLE)
    sample = [x[:, :k] for x in tensors]
    only_from = sample[len(sample) - seeds:] if seeds else None
    other, divisions = count_arithmetic(fn, st, *sample, only_from=only_from)
    return other / k * b, divisions / k * b


def udeb_year_work(st: UdebStatic, scal, ocean, init_prof, vec):
    """``(operations, divisions, bytes)`` of one launch on these inputs:
    the plain version's arithmetic (:func:`~.work.count_arithmetic`) on the
    first members, which every member repeats, scaled to the batch; the
    bytes of each input read once and each output written once."""
    b = ocean.shape[-1]
    other, divisions = _sampled(udeb_year_plain, st, b, scal, ocean, init_prof, vec)
    return other, divisions, _input_bytes(st, scal, ocean, vec) + scal.element_size() * (
        ocean.numel() + 8 * b)


def _jvp_of_plain(st, scal, ocean, init_prof, vec):
    """The tangent of :func:`udeb_year_plain` along the inputs themselves
    (what the tangent kernel computes, for its work)."""
    primals = (scal, ocean, init_prof, vec)
    return plain_jvp(functools.partial(udeb_year_plain, st), primals, primals)


def udeb_year_jvp_work(st: UdebStatic, scal, ocean, init_prof, vec):
    """``(operations, divisions, bytes)`` of one tangent launch: the
    arithmetic of ``plain_jvp`` of the plain version on the first members,
    scaled; each input and its tangent read once, each output tangent
    written once."""
    b = ocean.shape[-1]
    other, divisions = _sampled(_jvp_of_plain, st, b, scal, ocean, init_prof, vec)
    return other, divisions, 2 * _input_bytes(st, scal, ocean, vec) + scal.element_size() * (
        ocean.numel() + 8 * b)


def udeb_year_vjp_work(st: UdebStatic, scal, ocean, init_prof, vec, g_ocean, g_vec):
    """``(operations, divisions, bytes)`` of one adjoint launch: one
    forward (:func:`udeb_year_work`'s arithmetic) and the arithmetic of
    :func:`udeb_year_vjp_plain` that reads the cotangents, on the first
    members, scaled; the inputs and the cotangents read once, the four
    cotangents written once.  The forward values the reverse pass
    recomputes and the tape's traffic are the kernel's choice, not work the
    function needs, and are not counted."""
    b = ocean.shape[-1]
    fwd_other, fwd_divisions, _ = udeb_year_work(st, scal, ocean, init_prof, vec)
    other, divisions = _sampled(udeb_year_vjp_plain, st, b, scal, ocean, init_prof, vec,
                                g_ocean, g_vec, seeds=2)
    other, divisions = other + fwd_other, divisions + fwd_divisions
    size = scal.element_size()
    read = _input_bytes(st, scal, ocean, vec) + size * (ocean.numel() + 8 * b)
    return other, divisions, read + size * (scal.numel() + 2 * ocean.numel() + vec.numel())


#: kernel launches since each count was last set to 0
udeb_year.launches = 0
udeb_year_jvp.launches = 0
udeb_year_vjp.launches = 0
