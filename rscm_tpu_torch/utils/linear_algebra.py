"""
Small dense/banded linear-algebra kernels.

Mirror of ``crates/rscm-core/src/utils/linear_algebra.rs``:

- :func:`thomas_solve` — tridiagonal solve (used by the UDEB ocean column's
  implicit diffusion step).  Host path is straight float64; tensors run the
  same forward sweep / back substitution batched over leading axes
  (:func:`thomas_solve_batched`); :func:`thomas_solve_assoc` solves the
  same system by associative scans of depth ~log2(n).
- :func:`invert_4x4` — Gauss-Jordan with partial pivoting on the host (used
  by the LAMCALC 4x4 coupling-matrix inversion); tensors use the
  closed-form cofactor expansion (:func:`invert_4x4_traced`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "thomas_solve",
    "thomas_solve_batched",
    "thomas_solve_assoc",
    "invert_4x4",
    "invert_4x4_traced",
]


def _is_tensor(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


def thomas_solve(a, b, c, d):
    """Solve a tridiagonal system (sub-diag a, diag b, super-diag c, rhs d).

    ``a[0]`` and ``c[n-1]`` are ignored.  Returns x with ``len(b)`` entries.
    Tensors go through :func:`thomas_solve_batched` (same recursion).
    """
    if _is_tensor(a, b, c, d):
        return thomas_solve_batched(a, b, c, d)

    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)
    n = len(b)
    assert len(a) == n and len(c) == n and len(d) == n
    assert n > 0, "System must have at least one equation"
    assert abs(b[0]) > 1e-15, "Zero pivot encountered at row 0"

    c_prime = np.zeros(n)
    d_prime = np.zeros(n)
    c_prime[0] = c[0] / b[0]
    d_prime[0] = d[0] / b[0]
    for i in range(1, n):
        denom = b[i] - a[i] * c_prime[i - 1]
        assert abs(denom) > 1e-15, f"Zero pivot encountered at row {i}"
        if i < n - 1:
            c_prime[i] = c[i] / denom
        d_prime[i] = (d[i] - a[i] * d_prime[i - 1]) / denom

    x = np.zeros(n)
    x[n - 1] = d_prime[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = d_prime[i] - c_prime[i] * x[i + 1]
    return x


def thomas_solve_batched(a, b, c, d):
    """Tridiagonal solve along the trailing axis, batched over leading axes.

    Same recursion as :func:`thomas_solve` (sub-diag ``a``, diag ``b``,
    super-diag ``c``, rhs ``d``; ``a[..., 0]`` and ``c[..., -1]`` ignored),
    unrolled over the static layer count so every operation is elementwise
    over the leading batch axes (reference recursion:
    ``crates/rscm-core/src/utils/linear_algebra.rs:41``).
    """
    a, b, c, d = (torch.as_tensor(x) for x in (a, b, c, d))
    m = b.shape[-1]

    c_prime = [c[..., 0] / b[..., 0]]
    d_prime = [d[..., 0] / b[..., 0]]
    for i in range(1, m):
        denom = b[..., i] - a[..., i] * c_prime[i - 1]
        c_prime.append(c[..., i] / denom)
        d_prime.append((d[..., i] - a[..., i] * d_prime[i - 1]) / denom)

    x = [None] * m
    x[m - 1] = d_prime[m - 1]
    for i in range(m - 2, -1, -1):
        x[i] = d_prime[i] - c_prime[i] * x[i + 1]
    return torch.stack(x, dim=-1)


def _associative_scan(combine, elems):
    """Inclusive scan of the tuple of tensors ``elems`` along the last axis
    under the associative ``combine(earlier, later)``.

    The recursion of ``jax.lax.associative_scan`` (odd/even reduction), so
    every element is combined in the same order as in the JAX package."""
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    odd = _associative_scan(
        combine, combine(tuple(e[..., 0:-1:2] for e in elems), tuple(e[..., 1::2] for e in elems))
    )
    if n % 2 == 0:
        even = combine(tuple(e[..., :-1] for e in odd), tuple(e[..., 2::2] for e in elems))
    else:
        even = combine(odd, tuple(e[..., 2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        ev = torch.cat([e[..., :1], ev], dim=-1)
        full = e.new_empty(e.shape)
        full[..., 0::2] = ev
        full[..., 1::2] = od
        out.append(full)
    return tuple(out)


def thomas_solve_assoc(a, b, c, d):
    """Tridiagonal solve along the trailing axis by associative scans.

    Same system convention as :func:`thomas_solve_batched`.  Port of the
    JAX package's ``thomas_solve_assoc`` (``lax.associative_scan``):

    - the ``c'`` recurrence ``c'_i = c_i / (b_i - a_i c'_{i-1})`` is a
      Moebius transform of ``c'_{i-1}``, so prefixes compose as 2x2 matrix
      products, renormalised by their largest entry at each combine (the
      transform is scale-invariant; the rescale keeps products of many
      matrices from overflowing);
    - given ``c'``, the ``d'`` recurrence and the back substitution are
      affine recurrences ``y_i = u_i + v_i y_{i-1}``, composed as ``(u, v)``
      pairs.

    Agrees with the sequential sweep to ~1e-12 relative in float64 on
    diagonally dominant systems.
    """
    a, b, c, d = (torch.as_tensor(x) for x in (a, b, c, d))
    a0 = torch.cat([torch.zeros_like(a[..., :1]), a[..., 1:]], dim=-1)

    def moebius_combine(p, q):
        p00, p01, p10, p11 = p
        q00, q01, q10, q11 = q
        r00 = q00 * p00 + q01 * p10
        r01 = q00 * p01 + q01 * p11
        r10 = q10 * p00 + q11 * p10
        r11 = q10 * p01 + q11 * p11
        scale = torch.maximum(
            torch.maximum(r00.abs(), r01.abs()), torch.maximum(r10.abs(), r11.abs())
        )
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        return (r00 / scale, r01 / scale, r10 / scale, r11 / scale)

    _, p01, _, p11 = _associative_scan(moebius_combine, (torch.zeros_like(b), c, -a0, b))
    c_prime = p01 / p11

    def affine_combine(p, q):
        pu, pv = p
        qu, qv = q
        return (qu + qv * pu, qv * pv)

    c_prev = torch.cat([torch.zeros_like(c_prime[..., :1]), c_prime[..., :-1]], dim=-1)
    w = b - a0 * c_prev
    d_prime, _ = _associative_scan(affine_combine, (d / w, -a0 / w))

    ub = d_prime.flip(-1)
    vb = torch.cat([torch.zeros_like(c_prime[..., :1]), -c_prime.flip(-1)[..., 1:]], dim=-1)
    xb, _ = _associative_scan(affine_combine, (ub, vb))
    return xb.flip(-1)


def invert_4x4_traced(m):
    """Closed-form 4x4 inverse (cofactor/adjugate expansion) of tensors.

    Purely elementwise in the 16 entries, batched over leading axes: the
    same arithmetic as the TPU package's traced inverse.  The LAMCALC
    coupling matrices this inverts are small and well-conditioned, where
    the cofactor expansion is numerically fine.
    """
    m = torch.as_tensor(m)
    a = [[m[..., i, j] for j in range(4)] for i in range(4)]

    def det3(rows, cols):
        (r0, r1, r2), (c0, c1, c2) = rows, cols
        return (
            a[r0][c0] * (a[r1][c1] * a[r2][c2] - a[r1][c2] * a[r2][c1])
            - a[r0][c1] * (a[r1][c0] * a[r2][c2] - a[r1][c2] * a[r2][c0])
            + a[r0][c2] * (a[r1][c0] * a[r2][c1] - a[r1][c1] * a[r2][c0])
        )

    others = [tuple(k for k in range(4) if k != i) for i in range(4)]
    cof = [
        [(-1.0) ** (i + j) * det3(others[i], others[j]) for j in range(4)]
        for i in range(4)
    ]
    det = sum(a[0][j] * cof[0][j] for j in range(4))
    inv_det = 1.0 / det
    # inverse = adjugate / det = transpose(cofactor matrix) / det
    rows = [
        torch.stack([cof[j][i] * inv_det for j in range(4)], dim=-1) for i in range(4)
    ]
    return torch.stack(rows, dim=-2)


def invert_4x4(m):
    """Invert a 4x4 matrix; host path mirrors the reference's Gauss-Jordan
    (returns None when singular), tensors use the closed-form cofactor
    expansion (:func:`invert_4x4_traced`)."""
    if _is_tensor(m):
        return invert_4x4_traced(m)

    m = np.asarray(m, dtype=np.float64)
    assert m.shape == (4, 4)
    aug = np.concatenate([m.copy(), np.eye(4)], axis=1)
    for col in range(4):
        max_row = col + int(np.argmax(np.abs(aug[col:, col])))
        if abs(aug[max_row, col]) < 1e-12:
            return None
        if max_row != col:
            aug[[col, max_row]] = aug[[max_row, col]]
        aug[col] /= aug[col, col]
        for row in range(4):
            if row != col:
                aug[row] -= aug[row, col] * aug[col]
    return aug[:, 4:].copy()
