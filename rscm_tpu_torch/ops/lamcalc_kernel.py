"""
The LAMCALC feedback iteration per member: a CUDA kernel and its plain
PyTorch version, and the iteration's tangent and adjoint kernels with
theirs (:func:`lamcalc_jvp`, :func:`lamcalc_vjp`).

Replaces the Pallas kernel ``rscm_tpu/ops/lamcalc_kernel.py::
lamcalc_scalars`` (``pallas_call`` at ``lamcalc_kernel.py:252``, body
``_iteration`` at ``:59-185``).  For every member it runs the hybrid
step/secant iteration on lambda_ocean until the land/ocean warming ratio
matches RLO (at most 40 iterations, tolerance 1e-3), each iteration
taking the 4x4 coupling-matrix inverse by cofactors; a member that does not
converge takes the build-time fallback.

Layout is member-minor: the input is ``(6, B)`` — ecs, q, k_lo, k_ns, rlo,
alpha — and the output ``(3, B)`` — lam_o, lam_l, efficacy.

**The CUDA kernel** (``csrc/lamcalc.cu``): one thread per member, each
looping until its member converges (or for at most 39 further steps) and
then exiting.  The Pallas kernel had to unroll all 39 iterations (Mosaic
cannot lower the loop); converged members are frozen by the body, so
stopping early gives the same result (``lamcalc.py:277-280``).

*What bounds it on an H100:* arithmetic: ~350 floating-point operations an
iteration, 6-7 iterations a typical member, against 72 bytes in and out
per member in float64.  *What the design does about it:* the early exit
does only the iterations each member needs; a warp still runs as long as
its slowest member.

**The plain version** (:func:`lamcalc_plain`): the same iteration on
``(B,)`` tensors, at most 39 steps, left once every member has converged
(each member's iterate is frozen from its convergence on) — the twin of
the JAX package's fixed-count ``_ref_jnp``.  PyTorch's CUDA division by a host scalar
multiplies by its reciprocal; the kernel takes those reciprocals, taken in
the working dtype, as arguments.

**The derivatives** (:class:`LamcalcFunction`): on CUDA tensors the tangent
kernel (the iteration on dual numbers) and the adjoint kernel (a replay
that tapes each iterate, then the active iterations reversed), in the same
source; their plain versions are ``plain_jvp`` of :func:`lamcalc_plain`
and the explicit twin :func:`lamcalc_vjp_plain`.  Both differentiate the
iteration as the JAX package's fixed-count loop unrolls it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import build
from .plain_grad import plain_jvp
from .work import count_arithmetic, note_launch

__all__ = [
    "lamcalc",
    "lamcalc_plain",
    "lamcalc_plain_with_iterations",
    "lamcalc_scalars",
    "LamStatic",
    "SCALAR_ROWS",
    "lamcalc_work",
    "lamcalc_jvp",
    "lamcalc_jvp_work",
    "lamcalc_vjp",
    "lamcalc_vjp_plain",
    "lamcalc_vjp_work",
    "branch_codes",
]

#: packed per-member scalar input rows, in order
SCALAR_ROWS = ("ecs", "q", "k_lo", "k_ns", "rlo", "alpha")
S_IN = len(SCALAR_ROWS)
S_OUT = 3  # lam_o, lam_l, efficacy

MAX_ITERATIONS = 40
RLO_TOLERANCE = 0.001


@dataclass(frozen=True)
class LamStatic:
    """Build-time bundle: box fractions, qfrac weights, fallbacks."""

    fg: tuple  # (fgno, fgnl, fgso, fgsl)
    qfrac: tuple  # (4,) forcing fractions (from rf_regions_co2)
    rf_sum_zero: bool  # |rf . area| <= 1e-15 -> efficacy 1.0 branch
    fallback: tuple  # (lam_o, lam_l, efficacy) floats


def lam_static(params, fallback) -> LamStatic:
    """The static bundle from ``LamcalcParams`` and the build-time
    ``(lambda_ocean, lambda_land, matrix_inverse, co2_internal_efficacy)``
    fallback."""
    from rscm_tpu_torch.magicc.climate.lamcalc import compute_qfrac

    fg = (float(params.fgno), float(params.fgnl), float(params.fgso), float(params.fgsl))
    rf_regions = np.asarray(params.rf_regions_co2, dtype=np.float64)
    rf_sum = float(np.dot(rf_regions, np.array(fg)))
    return LamStatic(
        fg=fg,
        qfrac=tuple(float(v) for v in compute_qfrac(rf_regions, np.array(fg))),
        rf_sum_zero=abs(rf_sum) <= 1e-15,
        fallback=(float(fallback[0]), float(fallback[1]), float(fallback[3])),
    )


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _temps(st: LamStatic, q, k_lo, k_ns, alpha, lam_o, lam_l):
    """``y = M^-1 v`` by the cofactor inverse of the coupling matrix ``M``
    and the four box temperatures ``t = q y`` (the iteration's own; the
    adjoint reverses them through :class:`_Sparse`)."""
    fgno, fgnl, fgso, fgsl = st.fg
    q0, q1, q2, q3 = st.qfrac
    v = (fgno * q0, fgnl * q1, fgso * q2, fgsl * q3)
    # coupling-matrix entries; structural zeros stay host floats
    a_diag = k_lo * alpha + k_ns
    m = [
        [fgno * lam_o + a_diag, -k_lo, -k_ns, 0.0],
        [-k_lo * alpha, fgnl * lam_l + k_lo, 0.0, 0.0],
        [-k_ns, 0.0, fgso * lam_o + a_diag, -k_lo],
        [0.0, 0.0, -k_lo * alpha, fgsl * lam_l + k_lo],
    ]

    def det3(rows, cols):
        (r0, r1, r2), (c0, c1, c2) = rows, cols
        return (
            m[r0][c0] * (m[r1][c1] * m[r2][c2] - m[r1][c2] * m[r2][c1])
            - m[r0][c1] * (m[r1][c0] * m[r2][c2] - m[r1][c2] * m[r2][c0])
            + m[r0][c2] * (m[r1][c0] * m[r2][c1] - m[r1][c1] * m[r2][c0])
        )

    others = [tuple(k for k in range(4) if k != i) for i in range(4)]

    def cofactor(i, j):
        d = det3(others[i], others[j])
        return d if (i + j) % 2 == 0 else -d

    cof = [[cofactor(i, j) for j in range(4)] for i in range(4)]
    det = sum(m[0][j] * cof[0][j] for j in range(4))
    inv_det = 1.0 / det
    y = [sum((cof[j][i] * inv_det) * v[j] for j in range(4)) for i in range(4)]
    return y, [q * y[i] for i in range(4)]


class _Sparse:
    """``M^T`` by ``M``'s sparsity, for the adjoint (``Sparse`` in
    ``csrc/lamcalc.cu``, its operations in its order).  With ``b = k_lo
    alpha``, ``M = [[a0, -k_lo, -k_ns, 0], [-b, a1, 0, 0], [-k_ns, 0, a2,
    -k_lo], [0, 0, -b, a3]]``: rows 1 and 3 of ``M^T u = w`` each tie one
    unknown to ``u0`` or ``u2``; eliminating them leaves a 2x2 system whose
    determinant, times ``a1 a3``, is ``d = (a0 a1 - k_lo b)(a2 a3 - k_lo b)
    - k_ns^2 a1 a3``, and one division, ``1 / (a1 a3 d)``, gives ``1 / d``,
    ``1 / a1`` and ``1 / a3``."""

    def __init__(self, st: LamStatic, k_lo, k_ns, alpha, lam_o, lam_l):
        fgno, fgnl, fgso, fgsl = st.fg
        self.k_lo = k_lo
        self.b = b = k_lo * alpha
        a_diag = b + k_ns
        a0 = fgno * lam_o + a_diag
        self.a1 = a1 = fgnl * lam_l + k_lo
        a2 = fgso * lam_o + a_diag
        self.a3 = a3 = fgsl * lam_l + k_lo
        kb = k_lo * b
        p = a0 * a1 - kb
        s = a2 * a3 - kb
        a13 = a1 * a3
        d = p * s - (k_ns * k_ns) * a13
        rd = 1.0 / (a13 * d)
        inv_d = a13 * rd
        self.r1, self.r3 = (a3 * d) * rd, (a1 * d) * rd
        self.c00, self.c02 = s * inv_d, (k_ns * a1) * inv_d
        self.c20, self.c22 = (k_ns * a3) * inv_d, p * inv_d

    def solve_transposed(self, w):
        """``u = M^-T w``."""
        h0 = self.a1 * w[0] + self.b * w[1]
        h2 = self.a3 * w[2] + self.b * w[3]
        u0 = self.c00 * h0 + self.c02 * h2
        u2 = self.c20 * h0 + self.c22 * h2
        return [u0, (w[1] + self.k_lo * u0) * self.r1, u2, (w[3] + self.k_lo * u2) * self.r3]


def lamcalc_plain_with_iterations(st: LamStatic, packed, tape=None):
    """:func:`lamcalc_plain` plus, per member, the number of iterations the
    early-exit kernel runs (39 for a member that never converges).  A
    ``tape`` list receives each iteration's values for the adjoint twin
    (:func:`lamcalc_vjp_plain`)."""
    ecs, q, k_lo, k_ns, rlo, alpha = packed.unbind(0)
    fgno, fgnl, fgso, fgsl = st.fg
    fgosum = fgno + fgso
    fglsum = fgnl + fgsl
    fratio = fgosum / fglsum

    lam = q / ecs

    zeros = lam * 0.0
    lamo_im2, lamo_im1, lamo_i = lam + 0.0, lam + 0.0, lam + 0.7
    diff_im2, diff_im1 = zeros, zeros
    dlamo = zeros + 0.7
    iflag = torch.zeros_like(lam, dtype=torch.int32)
    found = torch.zeros_like(lam, dtype=torch.bool)
    iterations = torch.zeros_like(lam, dtype=torch.int32)
    best_lam_o = best_lam_l = best_eff = zeros
    for _ in range(MAX_ITERATIONS - 1):
        # once every member has converged the remaining iterations change
        # nothing (each member's iterate and result are frozen), so stop,
        # as the kernel stops each member: the values, and the gradients
        # through the iterates each member selected, are the same
        if bool(found.all()):
            break
        iterations = iterations + (~found).to(torch.int32)
        lam_l = lam + fratio * (lam - lamo_i) / rlo
        y, t = _temps(st, q, k_lo, k_ns, alpha, lamo_i, lam_l)
        ocean_mean = (fgno * t[0] + fgso * t[2]) / fgosum
        land_mean = (fgnl * t[1] + fgsl * t[3]) / fglsum
        diff_i = rlo - land_mean / ocean_mean

        t_global = fgno * t[0] + fgnl * t[1] + fgso * t[2] + fgsl * t[3]
        eff_i = t_global / ecs

        converged_now = (diff_i.abs() < RLO_TOLERANCE) & ~found
        best_lam_o = torch.where(converged_now, lamo_i, best_lam_o)
        best_lam_l = torch.where(converged_now, lam_l, best_lam_l)
        best_eff = torch.where(converged_now, eff_i, best_eff)
        found = found | converged_now

        sign_change = diff_i * diff_im1 < 0.0
        iflag = torch.where(sign_change, torch.ones_like(iflag), iflag)

        dlamo_step = torch.where(diff_i.abs() > diff_im1.abs(), -dlamo, dlamo)
        next_step = lamo_i + dlamo_step

        def secant(lamo_back, diff_back):
            denom = diff_i - diff_back
            small = denom.abs() < 1e-30
            return torch.where(
                small,
                lamo_i + dlamo,
                lamo_i - diff_i * (lamo_i - lamo_back)
                / torch.where(small, torch.ones_like(denom), denom),
            )

        secant1 = secant(lamo_im1, diff_im1)
        secant2 = secant(lamo_im2, diff_im2)

        lamo_next = torch.where(iflag == 0, next_step, torch.where(sign_change, secant1, secant2))
        if tape is not None:
            tape.append({
                "lamo": lamo_i, "lamo_im1": lamo_im1, "lamo_im2": lamo_im2, "diff": diff_i,
                "diff_im1": diff_im1, "diff_im2": diff_im2, "lam_l": lam_l, "y": y,
                "step": iflag == 0, "sign_change": sign_change,
            })
        dlamo = torch.where(iflag == 0, dlamo_step, dlamo)
        lamo_next = torch.where(found, lamo_i, lamo_next)
        lamo_im2, lamo_im1, lamo_i = lamo_im1, lamo_i, lamo_next
        diff_im2, diff_im1 = diff_im1, diff_i

    fb_lam_o, fb_lam_l, fb_eff = st.fallback
    lam_o = torch.where(found, best_lam_o, torch.full_like(best_lam_o, fb_lam_o))
    lam_l = torch.where(found, best_lam_l, torch.full_like(best_lam_l, fb_lam_l))
    efficacy = best_eff if not st.rf_sum_zero else torch.ones_like(best_eff)
    efficacy = torch.where(found, efficacy, torch.full_like(efficacy, fb_eff))
    return torch.stack([lam_o, lam_l, efficacy]), iterations


def lamcalc_plain(st: LamStatic, packed):
    """Plain PyTorch version of the kernel: ``(6, B)`` in, ``(3, B)`` out
    (twin of the JAX package's ``_ref_jnp``, whose fixed-count loop it
    leaves once every member has converged)."""
    return lamcalc_plain_with_iterations(st, packed)[0]


def branch_codes(st: LamStatic, packed) -> set:
    """The branch codes of the updates the adjoint reverses (those before
    each converging member's last iteration) on ``packed``: 0 a step, 1 and
    2 the secants through the previous iterate and the one before, 3 a
    secant whose denominator vanished."""
    tape = []
    _, iterations = lamcalc_plain_with_iterations(st, packed, tape=tape)
    reversed_ = iterations < MAX_ITERATIONS - 1
    codes = set()
    for j, rec in enumerate(tape):
        upd = reversed_ & (j < iterations - 1)
        back = torch.where(rec["sign_change"], rec["diff_im1"], rec["diff_im2"])
        stall = (rec["diff"] - back).abs() < 1e-30
        for code, on in ((0, rec["step"]), (1, ~rec["step"] & ~stall & rec["sign_change"]),
                         (2, ~rec["step"] & ~stall & ~rec["sign_change"]),
                         (3, ~rec["step"] & stall)):
            if bool((upd & on).any()):
                codes.add(code)
    return codes


def lamcalc_vjp_plain(st: LamStatic, packed, g_out):
    """Plain PyTorch version of the adjoint kernel (``lamcalc_vjp_kernel``,
    its operations in its order): the cotangent ``(6, B)`` of the input
    from that of the output ``(3, B)``.

    It replays the iteration (:func:`lamcalc_plain_with_iterations` with a
    tape, which keeps ``y = M^-1 v``), then reverses each member's active
    iterations, from the one it converged at down to the first, through the
    secant or step update and the temperatures ``t = q y`` (``M``'s
    cotangent is ``-(M^-T y_bar) y^T``, ``M^-T y_bar`` solved by
    :class:`_Sparse`).  A member that takes the fallback
    gets zero, as the JAX package's rule gives.  Each member's iterations
    run in the same order as the kernel's; a member past its convergence
    adds zeros.
    """
    ecs, q, k_lo, k_ns, rlo, alpha = packed.unbind(0)
    fgno, fgnl, fgso, fgsl = st.fg
    fg = st.fg
    fgosum, fglsum = fgno + fgso, fgnl + fgsl
    fratio = fgosum / fglsum
    tape = []
    with torch.no_grad():
        _, iterations = lamcalc_plain_with_iterations(st, packed, tape=tape)
        found = iterations < MAX_ITERATIONS - 1
        kstar = iterations - 1
        zero = torch.zeros_like(ecs)
        g_lo, g_ll, g_eff = g_out.unbind(0)
        bars = dict.fromkeys(SCALAR_ROWS, zero)
        lam = q / ecs
        inv_rlo, inv_ecs = 1.0 / rlo, 1.0 / ecs
        lam_bar = zero
        lamo_bar = [zero] * (len(tape) + 1)
        diff_bar = [zero] * (len(tape) + 1)

        def add(name, v):
            bars[name] = bars[name] + v

        for j in range(len(tape) - 1, -1, -1):
            rec = tape[j]
            lamo_i, diff_i = rec["lamo"], rec["diff"]
            act = found & (j <= kstar)
            # the update that made lamo_{j+1}: each branch adds lamo_i once
            upd = found & (j < kstar)
            big_l = torch.where(upd, lamo_bar[j + 1], zero)
            lamo_bar[j] = lamo_bar[j] + big_l
            sign_change = rec["sign_change"]
            lamo_back = torch.where(sign_change, rec["lamo_im1"], rec["lamo_im2"])
            diff_back = torch.where(sign_change, rec["diff_im1"], rec["diff_im2"])
            den = diff_i - diff_back
            secant = upd & ~rec["step"] & ~(den.abs() < 1e-30)
            inv_den = 1.0 / torch.where(secant, den, torch.ones_like(den))
            r = lamo_i - lamo_back
            qv = (diff_i * r) * inv_den
            p_bar = torch.where(secant, -big_l, zero) * inv_den
            den_bar = -(p_bar * qv)
            diff_bar[j] = diff_bar[j] + p_bar * r
            r_bar = p_bar * diff_i
            lamo_bar[j] = lamo_bar[j] + r_bar
            for k, on in ((j - 1, sign_change), (j - 2, ~sign_change)):
                if k >= 0:
                    lamo_bar[k] = lamo_bar[k] - torch.where(on, r_bar, zero)
            diff_bar[j] = diff_bar[j] + den_bar
            for k, on in ((j - 1, sign_change), (j - 2, ~sign_change)):
                if k >= 0:
                    diff_bar[k] = diff_bar[k] - torch.where(on, den_bar, zero)

            # the iteration's ratio, efficacy and land feedback
            seed = act & (j == kstar)
            lamo_bar[j] = lamo_bar[j] + torch.where(seed, g_lo, zero)
            ll_bar = torch.where(seed, g_ll, zero)
            eff_bar = zero if st.rf_sum_zero else torch.where(seed, g_eff, zero)
            sp = _Sparse(st, k_lo, k_ns, alpha, lamo_i, rec["lam_l"])
            y = rec["y"]
            t = [q * y[k] for k in range(4)]
            # (the kernel takes the efficacy's terms at the converged iterate
            # only: elsewhere they add zeros)
            tg = fgno * t[0] + fgnl * t[1] + fgso * t[2] + fgsl * t[3]
            tg_bar = eff_bar * inv_ecs
            add("ecs", -(tg_bar * (tg * inv_ecs)))
            t_bar = [tg_bar * fg[k] for k in range(4)]
            om = (fgno * t[0] + fgso * t[2]) / fgosum
            lm = (fgnl * t[1] + fgsl * t[3]) / fglsum
            inv_om = 1.0 / om
            db = torch.where(act, diff_bar[j], zero)
            add("rlo", db)
            lm_bar = -db * inv_om
            om_bar = -(lm_bar * (lm * inv_om))
            s_l = lm_bar / fglsum
            t_bar[1] = t_bar[1] + s_l * fgnl
            t_bar[3] = t_bar[3] + s_l * fgsl
            s_o = om_bar / fgosum
            t_bar[0] = t_bar[0] + s_o * fgno
            t_bar[2] = t_bar[2] + s_o * fgso
            add("q", ((t_bar[0] * y[0] + t_bar[1] * y[1]) + t_bar[2] * y[2]) + t_bar[3] * y[3])
            u = sp.solve_transposed([t_bar[k] * q for k in range(4)])

            def m_bar(a, b):
                return -(u[a] * y[b])

            lamo_bar[j] = lamo_bar[j] + m_bar(0, 0) * fgno
            ad_bar = m_bar(0, 0)
            add("k_lo", -m_bar(0, 1))
            add("k_ns", -m_bar(0, 2))
            add("k_lo", -(m_bar(1, 0) * alpha))
            add("alpha", -(m_bar(1, 0) * k_lo))
            ll_bar = ll_bar + m_bar(1, 1) * fgnl
            add("k_lo", m_bar(1, 1))
            add("k_ns", -m_bar(2, 0))
            lamo_bar[j] = lamo_bar[j] + m_bar(2, 2) * fgso
            ad_bar = ad_bar + m_bar(2, 2)
            add("k_lo", -m_bar(2, 3))
            add("k_lo", -(m_bar(3, 2) * alpha))
            add("alpha", -(m_bar(3, 2) * k_lo))
            ll_bar = ll_bar + m_bar(3, 3) * fgsl
            add("k_lo", m_bar(3, 3))
            add("k_lo", ad_bar * alpha)
            add("alpha", ad_bar * k_lo)
            add("k_ns", ad_bar)
            # lam_l = lam + w / rlo, w = fratio * (lam - lamo_i)
            lam_bar = lam_bar + ll_bar
            w = fratio * (lam - lamo_i)
            w_bar = ll_bar * inv_rlo
            add("rlo", -(w_bar * (w / rlo)))
            dl_bar = w_bar * fratio
            lam_bar = lam_bar + dl_bar
            lamo_bar[j] = lamo_bar[j] - dl_bar

        lam_bar = lam_bar + lamo_bar[0]
        lam_q = lam_bar * inv_ecs
        add("q", lam_q)
        add("ecs", -(lam_q * lam))
        out = torch.stack([bars[name] for name in SCALAR_ROWS])
    return torch.where(found, out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _consts(st: LamStatic, np_dtype) -> np.ndarray:
    """Kernel constants in the working dtype, as the plain version's
    PyTorch ops use them on the card (``csrc/lamcalc.cu``, ``enum Const``):
    fg(4), v(4), fratio, 1/fgosum, 1/fglsum, fallback(3)."""
    t = np_dtype.type
    fgno, fgnl, fgso, fgsl = st.fg
    q0, q1, q2, q3 = st.qfrac
    fgosum, fglsum = fgno + fgso, fgnl + fgsl
    vals = [
        *st.fg,
        fgno * q0, fgnl * q1, fgso * q2, fgsl * q3,
        fgosum / fglsum,
    ]
    out = [t(x) for x in vals]
    out += [t(1.0) / t(fgosum), t(1.0) / t(fglsum)]
    out += [t(x) for x in st.fallback]
    return np.ascontiguousarray(np.asarray(out, dtype=np_dtype))


def lamcalc(st: LamStatic, packed):
    """LAMCALC for every member: ``(6, B)`` in, ``(3, B)`` out.

    CPU tensors take :func:`lamcalc_plain`.  CUDA tensors launch the kernel
    (built on first use) through :class:`LamcalcFunction`, whose
    derivatives in both modes are kernels too; anything a kernel cannot
    take raises.
    """
    if packed.dim() != 2 or packed.shape[0] != S_IN:
        raise ValueError(f"lamcalc: input must be ({S_IN}, B), got {tuple(packed.shape)}")
    if packed.device.type == "cpu":
        return lamcalc_plain(st, packed)
    if packed.device.type != "cuda":
        raise ValueError(f"lamcalc: no kernel for device {packed.device}")
    return LamcalcFunction.apply(st, packed)


class LamcalcFunction(torch.autograd.Function):
    """The kernel and its derivative kernels.

    The JAX package wraps its Pallas kernel in a ``custom_jvp`` whose rule
    differentiates the kernel's ``jnp`` reference (``_jvp`` differentiates
    ``_ref_jnp``, ``rscm_tpu/ops/lamcalc_kernel.py:317-322``).  Here
    ``forward`` launches the CUDA kernel, ``jvp`` the tangent kernel
    (:func:`lamcalc_jvp`) and ``backward`` the adjoint kernel
    (:func:`lamcalc_vjp`), at the saved input; on CPU tensors, as the tests
    call it, the plain versions (``plain_jvp`` of :func:`lamcalc_plain`, the
    explicit adjoint :func:`lamcalc_vjp_plain`).  Gradients flow through
    the iterate each member converged at; a member that takes the fallback
    constants gets zero.
    """

    @staticmethod
    def forward(st, packed):
        return _lamcalc_forward(st, packed)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.st = inputs[0]
        ctx.save_for_backward(inputs[1])
        ctx.save_for_forward(inputs[1])

    @staticmethod
    def backward(ctx, g_out):
        if not ctx.needs_input_grad[1]:
            return None, None
        return None, lamcalc_vjp(ctx.st, ctx.saved_tensors[0], g_out)

    @staticmethod
    def jvp(ctx, _st_t, packed_t):
        return lamcalc_jvp(ctx.st, ctx.saved_tensors[0], packed_t)


def _lamcalc_forward(st: LamStatic, packed):
    """One launch of the kernel (the plain version on CPU tensors)."""
    if packed.device.type == "cpu":
        with torch.no_grad():
            return lamcalc_plain(st, packed)
    out = torch.empty((S_OUT, packed.shape[1]), dtype=packed.dtype, device=packed.device)
    _launch("lamcalc", st, packed, out, packed)
    lamcalc.launches += 1
    note_launch("lamcalc", lamcalc_work, st, packed)
    return out


def lamcalc_jvp(st: LamStatic, packed, packed_t):
    """The output's tangent ``(3, B)`` along ``packed_t`` (``None`` is
    zero) at ``packed``.

    CPU tensors take ``plain_jvp`` of :func:`lamcalc_plain`.  CUDA tensors
    launch the tangent kernel (``lamcalc_jvp_kernel``, ``csrc/lamcalc.cu``),
    which replaces the JAX package's rule ``_jvp``
    (``rscm_tpu/ops/lamcalc_kernel.py:317-322``, not a ``pallas_call``):
    the iteration on dual numbers, one thread a member, convergence and the
    freeze decided on the values, the iteration differentiated as the
    fixed-count loop unrolls it (not at the converged point).  *Bound:*
    operations at a large batch (~3x the forward's); at a gradient's batch
    one member's serial iterations.  *Design:* the forward's own iteration
    code, so the values are the forward's bit for bit; a member stops once
    it has converged; a fallback member's tangent is zero.
    """
    if packed.device.type == "cpu":
        return plain_jvp(functools.partial(lamcalc_plain, st), (packed,), (packed_t,))
    t = torch.zeros_like(packed) if packed_t is None else packed_t.contiguous()
    out = torch.empty((S_OUT, packed.shape[1]), dtype=packed.dtype, device=packed.device)
    _launch("lamcalc_jvp", st, packed, out, packed, t)
    lamcalc_jvp.launches += 1
    note_launch("lamcalc_jvp", lamcalc_jvp_work, st, packed)
    return out


def lamcalc_vjp(st: LamStatic, packed, g_out):
    """The input's cotangent ``(6, B)`` from the output's, ``g_out``
    ``(3, B)``, at ``packed``.

    CPU tensors take :func:`lamcalc_vjp_plain`.  CUDA tensors launch the
    adjoint kernel (``lamcalc_vjp_kernel``, ``csrc/lamcalc.cu``), which
    replaces the JAX package's rule ``_jvp`` transposed by JAX
    (``rscm_tpu/ops/lamcalc_kernel.py:317-322``, not a ``pallas_call``).
    *Bound:* operations at a large batch (the function needs ~1.4x the
    forward's arithmetic, one forward and the adjoint; the kernel performs
    ~1.7x, with the replay and the ratio its reverse pass recomputes); at a
    gradient's batch one member's serial iterations.  *Design:* one thread
    a member replays its iterations with the forward's code, taping each
    iterate, its ratio and ``y = M^-1 v`` in local memory (at most 39) and
    its update's branch in 2 bits of a register, then reverses them from
    the one it converged at, holding the cotangents of the iterations an
    update reaches (j + 1 down to j - 2) in registers; the temperatures are
    reversed as ``-(M^-T y_bar) y^T`` with ``M^-T y_bar`` solved through
    ``M``'s sparsity (:class:`_Sparse`), not the cofactors.  A fallback
    member gets zero.
    """
    if packed.device.type == "cpu":
        return lamcalc_vjp_plain(st, packed, g_out)
    out = torch.empty_like(packed)
    _launch("lamcalc_vjp", st, packed, out, packed, g_out.contiguous())
    lamcalc_vjp.launches += 1
    note_launch("lamcalc_vjp", lamcalc_vjp_work, st, packed, g_out)
    return out


def _launch(kernel: str, st: LamStatic, packed, out, *inputs):
    """Launch ``<kernel>_<dtype>`` of ``csrc/lamcalc.cu`` on ``inputs``
    (``(rows, B)`` CUDA tensors like ``packed``) into ``out``."""
    if packed.dtype not in _SUFFIX:
        raise TypeError(f"{kernel}: the kernel takes float32 or float64, not {packed.dtype}")
    for x in inputs:
        if (x.device != packed.device or x.dtype != packed.dtype or not x.is_contiguous()
                or x.shape[1:] != packed.shape[1:]):
            raise ValueError(f"{kernel}: inputs must be contiguous {packed.dtype} (rows, "
                             f"{packed.shape[1]}) on {packed.device}, got {tuple(x.shape)}")
    suffix = _SUFFIX[packed.dtype]
    p = ctypes.c_void_p
    fn = build.function("lamcalc", f"{kernel}_{suffix}",
                        [p, ctypes.c_int, ctypes.c_int, *([p] * len(inputs)), p, ctypes.c_longlong,
                         p])
    consts = _consts(st, np.dtype(np.float32 if suffix == "f32" else np.float64))
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(consts.ctypes.data, consts.size, int(st.rf_sum_zero),
                 *(x.data_ptr() for x in inputs), out.data_ptr(), packed.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error {err}")


#: members of a launch whose plain version is counted for its work
_WORK_SAMPLE = 256


def _scaled_work(st: LamStatic, packed, fn, *args, seeds=0):
    """``(other, divisions)`` of ``fn(st, sample, *args' samples)`` on the
    first members, over the iterations the slowest of them runs, times the
    iterations each member of the batch needs (each kernel stops a member
    when it converges); with ``seeds``, only the arithmetic that reads the
    last ``seeds`` of ``args``."""
    b = packed.shape[1]
    k = min(b, _WORK_SAMPLE)
    sample = packed[:, :k]
    steps = int(lamcalc_plain_with_iterations(st, sample)[1].max())
    arg_samples = [a[:, :k] for a in args]
    only_from = arg_samples[len(arg_samples) - seeds:] if seeds else None
    other, divisions = count_arithmetic(fn, st, sample, *arg_samples, only_from=only_from)
    iterations = float(lamcalc_plain_with_iterations(st, packed)[1].double().sum())
    scale = iterations / (k * steps)
    return other * scale, divisions * scale


def lamcalc_work(st: LamStatic, packed):
    """``(operations, divisions, bytes)`` of one launch on ``packed``: the
    plain version's arithmetic per member-iteration
    (:func:`~.work.count_arithmetic` on the first members, over the
    iterations the slowest of them runs) times the iterations each member
    of the batch needs (the kernel stops each member when it converges);
    the bytes of the input read once and the output written once."""
    nbytes = packed.element_size() * (packed.numel() + S_OUT * packed.shape[1])
    return (*_scaled_work(st, packed, lamcalc_plain), nbytes)


def _jvp_of_plain(st, packed):
    """The tangent of :func:`lamcalc_plain` along the input itself (what
    the tangent kernel computes, for its work)."""
    return plain_jvp(functools.partial(lamcalc_plain, st), (packed,), (packed,))


def lamcalc_jvp_work(st: LamStatic, packed):
    """``(operations, divisions, bytes)`` of one tangent launch: the
    arithmetic of ``plain_jvp`` of the plain version, scaled as
    :func:`lamcalc_work` scales it; the input and its tangent read once,
    the output's tangent written once."""
    nbytes = packed.element_size() * (2 * packed.numel() + S_OUT * packed.shape[1])
    return (*_scaled_work(st, packed, _jvp_of_plain), nbytes)


def lamcalc_vjp_work(st: LamStatic, packed, g_out):
    """``(operations, divisions, bytes)`` of one adjoint launch: one
    forward (:func:`lamcalc_work`'s arithmetic) and the arithmetic of
    :func:`lamcalc_vjp_plain` that reads the output's cotangent, scaled as
    :func:`lamcalc_work` scales it; the input and the output's cotangent
    read once, the input's cotangent written once.  The replay and the
    values the reverse pass recomputes (the ratio, ``M``'s entries and the
    solve's coefficients) are the kernel's choice, not work the function
    needs, and are not counted."""
    nbytes = packed.element_size() * (2 * packed.numel() + S_OUT * packed.shape[1])
    fwd_other, fwd_divisions, _ = lamcalc_work(st, packed)
    other, divisions = _scaled_work(st, packed, lamcalc_vjp_plain, g_out, seeds=1)
    return other + fwd_other, divisions + fwd_divisions, nbytes


#: kernel launches since each count was last set to 0
lamcalc.launches = 0
lamcalc_jvp.launches = 0
lamcalc_vjp.launches = 0


def lamcalc_scalars(params, ecs, fallback, engine: str = "cuda"):
    """``(lam_o, lam_l, efficacy)`` for a per-member adjusted ECS.

    ``params`` is a ``LamcalcParams`` whose entries are host floats or
    ``(B,)`` tensors; ``ecs`` a ``(B,)`` tensor; ``fallback`` the build-time
    ``(lambda_ocean, lambda_land, matrix_inverse, co2_internal_efficacy)``.
    ``engine="cuda"`` goes through :func:`lamcalc`,
    ``engine="torch"`` through :func:`lamcalc_plain`.
    """
    st = lam_static(params, fallback)
    like = dict(dtype=ecs.dtype, device=ecs.device)
    rows = [ecs, params.q_2xco2, params.k_lo, params.k_ns, params.rlo,
            params.amplify_ocean_to_land]
    packed = torch.stack([torch.as_tensor(r, **like).expand(ecs.shape) for r in rows])
    fn = lamcalc if engine == "cuda" else lamcalc_plain
    out = fn(st, packed)
    return out[0], out[1], out[2]
