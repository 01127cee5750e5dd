"""
Fixed-step RK4 sub-stepping for per-component ODE solves.

Port of ``rscm_tpu/core/ivp.py`` (itself a mirror of
``crates/rscm-core/src/ivp/mod.rs`` + the ``ode_solvers`` Rk4 it wraps): a
component integrates its ODE over one model step ``[t0, t1]`` with a fixed
sub-step (typically 0.1 yr inside an annual step), and the landing time
must be within ``T_THRESHOLD = 5e-3`` of ``t1`` (``ivp/mod.rs:9,90-102``).

The sub-step count comes from the model's time axis (``SolveContext.spans``)
in the year loop and from the step's own bounds in the step-by-step
executor.  The same code runs on host floats and on tensors with a member
axis: ``y`` is a tuple of scalars or ``(members,)`` tensors, and the
derivative function ``f(t, y) -> dy/dt tuple`` reads forcings from windows
captured in its closure (constant over the step via ``get()``, matching
the reference components).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np

__all__ = ["T_THRESHOLD", "substep_count", "rk4_integrate", "solve_ivp_rk4"]

T_THRESHOLD = 5e-3


def substep_count(ctx, step_size: float) -> int:
    """Number of RK4 sub-steps for this model step.

    Mirrors ``ode_solvers`` Rk4's ``ceil(span / step)`` count and the
    reference's end-time assertion.  In the year loop every model step
    must yield the same count (a uniform axis), as in the TPU package,
    where one step program serves every scan iteration.
    """
    spans = getattr(ctx, "spans", None)
    if spans is None:
        # step-by-step executor: this step's own bounds
        spans = np.asarray([float(ctx.t_next) - float(ctx.t_current)])
    else:
        spans = np.asarray(spans, dtype=np.float64)

    counts = np.ceil(spans / step_size - 1e-9).astype(int)
    n = int(counts[0])
    if not np.all(counts == n):
        raise ValueError(
            "RK4 sub-step count varies across the time axis "
            f"(counts {sorted(set(counts.tolist()))}); a non-uniform axis "
            "cannot run in the year loop. "
            "Run the model with compiled=False or use a uniform axis."
        )
    landing_err = np.max(np.abs(counts * step_size - spans))
    assert landing_err < T_THRESHOLD, (
        f"RK4 landing time misses the step end by {landing_err:.3e} "
        f"(> {T_THRESHOLD}); choose a step_size that divides the axis step."
    )
    return n


def _add(y: Tuple, k: Tuple, h):
    return tuple(yi + ki * h for yi, ki in zip(y, k))


def _rk4_step(f: Callable, y: Tuple, t, h) -> Tuple:
    k1 = f(t, y)
    k2 = f(t + h / 2.0, _add(y, k1, h / 2.0))
    k3 = f(t + h / 2.0, _add(y, k2, h / 2.0))
    k4 = f(t + h, _add(y, k3, h))
    return tuple(
        yi + (k1i + 2.0 * k2i + 2.0 * k3i + k4i) * (h / 6.0)
        for yi, k1i, k2i, k3i, k4i in zip(y, k1, k2, k3, k4)
    )


def rk4_integrate(f: Callable, y0: Tuple, t0, step_size: float, n: int) -> Tuple:
    """Classic RK4 with ``n`` fixed sub-steps of width ``step_size``.

    Arithmetic matches ``ode_solvers``' Rk4:
    ``y += (k1 + 2 k2 + 2 k3 + k4) * (h/6)``.  The sub-steps are a plain
    Python loop (the TPU package rolls them into a ``lax.fori_loop`` under
    tracing, with the same arithmetic).
    """
    h = step_size
    y = tuple(y0)
    for i in range(n):
        y = _rk4_step(f, y, t0 + i * h, h)
    return y


def solve_ivp_rk4(f: Callable, y0: Sequence, ctx, step_size: float = 0.1) -> Tuple:
    """Integrate ``dy/dt = f(t, y)`` over the model step in ``ctx``.

    Equivalent of ``IVPBuilder::to_rk4(t0, t1, step).integrate()`` +
    ``get_last_step`` (``ivp/mod.rs:245,90``).
    """
    n = substep_count(ctx, step_size)
    return rk4_integrate(f, tuple(y0), ctx.t_current, step_size, n)
