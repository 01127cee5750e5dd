"""
The LAMCALC feedback iteration per member: a CUDA kernel and its plain
PyTorch version.

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
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .plain_grad import plain_jvp, plain_vjp
from .work import count_arithmetic, note_launch

__all__ = [
    "lamcalc",
    "lamcalc_plain",
    "lamcalc_plain_with_iterations",
    "lamcalc_scalars",
    "LamStatic",
    "SCALAR_ROWS",
    "lamcalc_work",
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


def lamcalc_plain_with_iterations(st: LamStatic, packed):
    """:func:`lamcalc_plain` plus, per member, the number of iterations the
    early-exit kernel runs (39 for a member that never converges)."""
    ecs, q, k_lo, k_ns, rlo, alpha = packed.unbind(0)
    fgno, fgnl, fgso, fgsl = st.fg
    q0, q1, q2, q3 = st.qfrac
    v = (fgno * q0, fgnl * q1, fgso * q2, fgsl * q3)
    fgosum = fgno + fgso
    fglsum = fgnl + fgsl
    fratio = fgosum / fglsum

    lam = q / ecs

    def temps_from(lam_o, lam_l):
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
        return [q * sum((cof[j][i] * inv_det) * v[j] for j in range(4)) for i in range(4)]

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
        t = temps_from(lamo_i, lam_l)
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
    (built on first use); anything the kernel cannot take raises.
    """
    if packed.dim() != 2 or packed.shape[0] != S_IN:
        raise ValueError(f"lamcalc: input must be ({S_IN}, B), got {tuple(packed.shape)}")
    if packed.device.type == "cpu":
        return lamcalc_plain(st, packed)
    if packed.device.type != "cuda":
        raise ValueError(f"lamcalc: no kernel for device {packed.device}")
    return LamcalcFunction.apply(st, packed)


class LamcalcFunction(torch.autograd.Function):
    """The kernel's forward with the plain version's derivatives.

    The twin of the JAX package's ``custom_jvp`` around the Pallas kernel
    (``_jvp`` differentiates ``_ref_jnp``, ``lamcalc_kernel.py:317-325``):
    there is no backward kernel.  ``forward`` launches the CUDA kernel (the
    plain version without a tape on CPU tensors, as the tests call it);
    ``backward`` and ``jvp`` differentiate :func:`lamcalc_plain` at the
    saved input.  Gradients flow through the iterate the plain version
    selects; a member that takes the fallback constants gets zero.
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
        (grad,) = plain_vjp(functools.partial(lamcalc_plain, ctx.st), ctx.saved_tensors,
                             ctx.needs_input_grad[1:], (g_out,))
        return None, grad

    @staticmethod
    def jvp(ctx, _st_t, packed_t):
        return plain_jvp(functools.partial(lamcalc_plain, ctx.st), ctx.saved_tensors, (packed_t,))


def _lamcalc_forward(st: LamStatic, packed):
    """One launch of the kernel (the plain version on CPU tensors)."""
    if packed.device.type == "cpu":
        with torch.no_grad():
            return lamcalc_plain(st, packed)
    if packed.dtype not in _SUFFIX:
        raise TypeError(f"lamcalc: the kernel takes float32 or float64, not {packed.dtype}")
    if not packed.is_contiguous():
        raise ValueError("lamcalc: input must be contiguous")

    from . import build

    b = packed.shape[1]
    suffix = _SUFFIX[packed.dtype]
    fn = getattr(build.load("lamcalc"), f"lamcalc_{suffix}")
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_int, ctypes.c_int, p, p, ctypes.c_longlong, p]
    fn.restype = ctypes.c_int
    consts = _consts(st, np.dtype(np.float32 if suffix == "f32" else np.float64))
    out = torch.empty((S_OUT, b), dtype=packed.dtype, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(consts.ctypes.data, consts.size, int(st.rf_sum_zero),
                 packed.data_ptr(), out.data_ptr(), b, stream)
    if err != 0:
        raise RuntimeError(f"lamcalc: kernel launch failed with CUDA error {err}")
    lamcalc.launches += 1
    note_launch("lamcalc", lamcalc_work, st, packed)
    return out


#: members of a launch whose plain version is counted for its work
_WORK_SAMPLE = 256


def lamcalc_work(st: LamStatic, packed):
    """``(operations, divisions, bytes)`` of one launch on ``packed``: the
    plain version's arithmetic per member-iteration
    (:func:`~.work.count_arithmetic` on the first members, over the
    iterations the slowest of them runs) times the iterations each member
    of the batch needs (the kernel stops each member when it converges);
    the bytes of the input read once and the output written once."""
    b = packed.shape[1]
    sample = packed[:, : min(b, _WORK_SAMPLE)]
    steps = int(lamcalc_plain_with_iterations(st, sample)[1].max())
    other, divisions = count_arithmetic(lamcalc_plain, st, sample)
    iterations = float(lamcalc_plain_with_iterations(st, packed)[1].double().sum())
    scale = iterations / (sample.shape[1] * steps)
    nbytes = packed.element_size() * (packed.numel() + S_OUT * b)
    return other * scale, divisions * scale, nbytes


#: kernel launches since the count was last set to 0
lamcalc.launches = 0


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
