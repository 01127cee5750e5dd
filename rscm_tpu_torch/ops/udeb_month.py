"""
One year of ClimateUDEB monthly sub-steps per member: a CUDA kernel and its
plain PyTorch version.

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
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.linear_algebra import thomas_solve_assoc
from .plain_grad import plain_jvp, plain_vjp
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
]

#: packed per-member scalar rows, in order
SCALAR_ROWS = (
    "lam_o", "lam_l", "kappa", "kappa_dkdt", "kappa_min",
    "w_initial", "w_var_frac", "k_lo", "k_ns", "k_lg",
    "amplify", "pi_ratio", "adj_alpha", "adj_gamma", "max_temp",
    "c_ground", "erf_start", "erf_end", "t_polar",
)
S = len(SCALAR_ROWS)

@functools.lru_cache(maxsize=None)
def max_kernel_layers(dtype) -> int:
    """The most layers the CUDA kernel takes in ``dtype``, as the kernel's
    library states it (``csrc/udeb_year.cu``, ``max_layers``): a block of one
    warp must fit the shared memory a block may use.  Builds the kernel on
    first use."""
    return int(_lib_fn(f"udeb_year_max_layers_{_SUFFIX[dtype]}", [])())


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
                 alpha_eff, init_prof, frac, tridiag="sequential"):
    """One monthly sub-step on ``(2, n, B)`` / ``(2, B)`` tensors
    (transcription of ``_month_body``); ``tridiag="assoc"`` solves the
    column by associative scans instead of the Thomas sweep."""
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
    kappa = torch.maximum(
        (one_minus_rel * dkdt_term[:, None] + sc["kappa"]) * st.diffusivity_scale,
        sc["kappa_min"],
    )  # (2, n-1, B)

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


def _check_layers(n: int, dtype):
    limit = max_kernel_layers(dtype)
    if n > limit:
        raise ValueError(
            f"udeb_year: the CUDA kernel takes at most {limit} layers in {dtype}, not {n}: "
            f"a block of one warp keeps {n} layers per thread in shared memory, more than "
            f"a block may use"
        )


def _lib_fn(name: str, argtypes):
    from . import build

    fn = getattr(build.load("udeb_year"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def kernel_config(n: int, dtype, device=None) -> dict:
    """The CUDA kernel's launch configuration at ``n`` layers on the current
    (or given) card: threads per block, resident blocks per SM (from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and shared bytes per
    block.  Raises above :func:`max_kernel_layers`."""
    _check_layers(n, dtype)
    p = ctypes.POINTER
    fn = _lib_fn(f"udeb_year_config_{_SUFFIX[dtype]}",
                 [ctypes.c_int, p(ctypes.c_int), p(ctypes.c_int), p(ctypes.c_longlong)])
    threads, blocks, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = fn(n, ctypes.byref(threads), ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"udeb_year: no launch configuration at {n} layers (CUDA error {err})")
    return {"threads": threads.value, "blocks_per_sm": blocks.value, "shared_bytes": smem.value}


def udeb_year(st: UdebStatic, scal, ocean, init_prof, vec):
    """One year of monthly sub-steps for every member.

    CPU tensors take :func:`udeb_year_plain`, at any layer count, and
    autograd goes through it.  CUDA tensors launch the kernel (built on
    first use) at any layer count up to :func:`max_kernel_layers`, through
    :class:`UdebYearFunction`, so gradients in both modes come from the
    plain version; anything the kernel cannot take raises.
    """
    _check(st, scal, ocean, init_prof, vec)
    if ocean.device.type == "cpu":
        return udeb_year_plain(st, scal, ocean, init_prof, vec)
    if ocean.device.type != "cuda":
        raise ValueError(f"udeb_year: no kernel for device {ocean.device}")
    return UdebYearFunction.apply(st, scal, ocean, init_prof, vec)


class UdebYearFunction(torch.autograd.Function):
    """The kernel's forward with the plain version's derivatives.

    The twin of the JAX package's ``custom_jvp`` around the Pallas kernel
    (``_year_jvp`` differentiates ``_ref_single``, ``udeb_month.py:530-548``):
    there is no backward kernel.  ``forward`` launches the CUDA kernel
    (:func:`_udeb_year_forward`; on CPU tensors, as the tests call it, the
    plain version without a tape); ``backward`` recomputes
    :func:`udeb_year_plain` on the saved inputs under autograd and takes
    its vector-Jacobian product; ``jvp`` takes the plain version's
    Jacobian-vector product with ``torch.func.jvp``.
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
        return (None, *plain_vjp(
            functools.partial(udeb_year_plain, ctx.st), ctx.saved_tensors,
            ctx.needs_input_grad[1:], (g_ocean, g_vec),
        ))

    @staticmethod
    def jvp(ctx, _st_t, *tangents):
        return plain_jvp(functools.partial(udeb_year_plain, ctx.st), ctx.saved_tensors, tangents)


def _udeb_year_forward(st: UdebStatic, scal, ocean, init_prof, vec):
    """One launch of the kernel (the plain version on CPU tensors)."""
    if ocean.device.type == "cpu":
        with torch.no_grad():
            return udeb_year_plain(st, scal, ocean, init_prof, vec)
    if ocean.dtype not in _SUFFIX:
        raise TypeError(f"udeb_year: the kernel takes float32 or float64, not {ocean.dtype}")
    _check_layers(st.n, ocean.dtype)
    for name, x in (("scal", scal), ("ocean", ocean), ("vec", vec)):
        if not x.is_contiguous():
            raise ValueError(f"udeb_year: {name} must be contiguous")

    b = ocean.shape[-1]
    p = ctypes.c_void_p
    fn = _lib_fn(f"udeb_year_{_SUFFIX[ocean.dtype]}",
                 [p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, p,
                  ctypes.c_longlong, ctypes.c_longlong, p, p, p, ctypes.c_longlong, p])
    consts, layers = _kernel_geom(st, ocean.dtype, ocean.device)
    ocean_out = torch.empty_like(ocean)
    vec_out = torch.empty((8, b), dtype=ocean.dtype, device=ocean.device)
    with torch.cuda.device(ocean.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            consts.ctypes.data, consts.size, st.n, st.steps, int(st.land_heat_enabled),
            layers.data_ptr(), scal.data_ptr(), ocean.data_ptr(), init_prof.data_ptr(),
            init_prof.stride(0), init_prof.stride(1),
            vec.data_ptr(), ocean_out.data_ptr(), vec_out.data_ptr(), b, stream,
        )
    if err != 0:
        raise RuntimeError(f"udeb_year: kernel launch failed with CUDA error {err}")
    udeb_year.launches += 1
    note_launch("udeb_year", udeb_year_work, st, scal, ocean, init_prof, vec)
    return ocean_out, vec_out


#: members of a launch whose plain version is counted for its work
_WORK_SAMPLE = 256


def udeb_year_work(st: UdebStatic, scal, ocean, init_prof, vec):
    """``(operations, divisions, bytes)`` of one launch on these inputs:
    the plain version's arithmetic (:func:`~.work.count_arithmetic`) on the
    first members, which every member repeats, scaled to the batch; the
    bytes of each input read once and each output written once."""
    b = ocean.shape[-1]
    k = min(b, _WORK_SAMPLE)
    other, divisions = count_arithmetic(
        udeb_year_plain, st, scal[:, :k], ocean[:, :k], init_prof[:, :k], vec[:, :k]
    )
    nbytes = scal.element_size() * (
        scal.numel() + ocean.numel() + 2 * st.n + vec.numel() + ocean.numel() + 8 * b
    )
    return other / k * b, divisions / k * b, nbytes


#: kernel launches since the count was last set to 0
udeb_year.launches = 0
