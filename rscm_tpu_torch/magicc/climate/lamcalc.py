"""
LAMCALC: solve for ocean/land feedback parameters matching a target ECS and
land-ocean warming ratio.

Mirror of ``crates/rscm-magicc/src/climate/lamcalc.rs``: hybrid step/secant
iteration on lambda_ocean (<= 40 iterations, RLO tolerance 1e-3) through a
4x4 regional coupling-matrix inversion; also computes the CO2 internal
efficacy.  Runs on the host in float64 — its products (lambda_ocean,
lambda_land, matrix inverse) are build-time constants of ClimateUDEB.

The per-member tensor form, which re-derives the feedbacks every year from
the time-varying ECS (the TPU package's ``lamcalc_traced``), is
:func:`rscm_tpu_torch.ops.lamcalc_kernel.lamcalc_scalars`: a CUDA kernel
and its plain PyTorch version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from rscm_tpu_torch.utils.linear_algebra import invert_4x4

__all__ = [
    "LamcalcParams",
    "LamcalcResult",
    "lamcalc",
    "build_coupling_matrix",
    "compute_qfrac",
    "calc_internal_efficacy",
]

MAX_ITERATIONS = 40
RLO_TOLERANCE = 0.001


@dataclass
class LamcalcParams:
    q_2xco2: float
    k_lo: float
    k_ns: float
    ecs: float
    rlo: float
    amplify_ocean_to_land: float
    fgno: float
    fgnl: float
    fgso: float
    fgsl: float
    rf_regions_co2: tuple


@dataclass
class LamcalcResult:
    lambda_ocean: float
    lambda_land: float
    matrix_inverse: np.ndarray
    co2_internal_efficacy: float


def build_coupling_matrix(params: LamcalcParams, lam_o: float, lam_l: float) -> np.ndarray:
    alpha = params.amplify_ocean_to_land
    k_lo = params.k_lo
    k_ns = params.k_ns
    return np.array(
        [
            [params.fgno * lam_o + k_lo * alpha + k_ns, -k_lo, -k_ns, 0.0],
            [-k_lo * alpha, params.fgnl * lam_l + k_lo, 0.0, 0.0],
            [-k_ns, 0.0, params.fgso * lam_o + k_lo * alpha + k_ns, -k_lo],
            [0.0, 0.0, -k_lo * alpha, params.fgsl * lam_l + k_lo],
        ]
    )


def compute_qfrac(rf_regions, area) -> np.ndarray:
    rf_regions = np.asarray(rf_regions, dtype=np.float64)
    area = np.asarray(area, dtype=np.float64)
    rf_sum = float(np.dot(rf_regions, area))
    if abs(rf_sum) <= 1e-15:
        return np.ones(4)
    return rf_regions / rf_sum


def _box_temperatures(q, matrix_inverse, area, qfrac) -> np.ndarray:
    return q * (matrix_inverse @ (np.asarray(area) * np.asarray(qfrac)))


def calc_internal_efficacy(q_2xco2, matrix_inverse, area, rf_regions, ecs) -> float:
    rf_regions = np.asarray(rf_regions, dtype=np.float64)
    area = np.asarray(area, dtype=np.float64)
    rf_sum = float(np.dot(rf_regions, area))
    if abs(rf_sum) <= 1e-15:
        return 1.0
    qfrac = compute_qfrac(rf_regions, area)
    temps = _box_temperatures(q_2xco2, matrix_inverse, area, qfrac)
    t_global = float(np.dot(area, temps))
    return t_global / ecs


def lamcalc(params: LamcalcParams) -> Optional[LamcalcResult]:
    """Iterate lambda_ocean until the land/ocean warming ratio matches RLO."""
    lam = params.q_2xco2 / params.ecs
    fgosum = params.fgno + params.fgso
    fglsum = params.fgnl + params.fgsl
    fratio = fgosum / fglsum

    area = np.array([params.fgno, params.fgnl, params.fgso, params.fgsl])
    qfrac = compute_qfrac(params.rf_regions_co2, area)

    lamo = np.zeros(MAX_ITERATIONS + 2)
    diff = np.zeros(MAX_ITERATIONS + 2)
    lamo[1] = lam
    lamo[2] = lam + 0.7

    dlamo = 0.7
    iflag = 0

    for i in range(2, MAX_ITERATIONS + 1):
        lam_l = lam + fratio * (lam - lamo[i]) / params.rlo
        lam_o = lamo[i]

        matrix = build_coupling_matrix(params, lam_o, lam_l)
        inv = invert_4x4(matrix)
        if inv is None:
            return None

        temps = _box_temperatures(params.q_2xco2, inv, area, qfrac)
        ocean_mean = (params.fgno * temps[0] + params.fgso * temps[2]) / fgosum
        land_mean = (params.fgnl * temps[1] + params.fgsl * temps[3]) / fglsum
        rlo_est = land_mean / ocean_mean

        diff[i] = params.rlo - rlo_est
        if abs(diff[i]) < RLO_TOLERANCE:
            efficacy = calc_internal_efficacy(
                params.q_2xco2, inv, area, params.rf_regions_co2, params.ecs
            )
            return LamcalcResult(lam_o, lam_l, inv, efficacy)

        if diff[i] * diff[i - 1] < 0.0:
            iflag = 1

        if iflag == 0:
            if abs(diff[i]) > abs(diff[i - 1]):
                dlamo = -dlamo
            lamo[i + 1] = lamo[i] + dlamo
        elif diff[i] * diff[i - 1] < 0.0:
            denom = diff[i] - diff[i - 1]
            if abs(denom) < 1e-30:
                lamo[i + 1] = lamo[i] + dlamo
            else:
                lamo[i + 1] = lamo[i] - diff[i] * (lamo[i] - lamo[i - 1]) / denom
        else:
            i2 = i - 2 if i >= 2 else 0
            denom = diff[i] - diff[i2]
            if abs(denom) < 1e-30:
                lamo[i + 1] = lamo[i] + dlamo
            else:
                lamo[i + 1] = lamo[i] - diff[i] * (lamo[i] - lamo[i2]) / denom

    return None
