"""Calibration framework (reference surface of ``rscm.calibrate``)."""

import sys as _sys

from rscm_tpu_torch.calibrate import (
    HAS_PANDAS,
    Bound,
    Chain,
    CompiledModelRunner,
    DefaultModelRunner,
    EnsembleSampler,
    GaussianLikelihood,
    LogNormal,
    ModelRunner,
    Normal,
    Observation,
    ParameterSet,
    PointEstimate as OptimizationResult,
    PointEstimator,
    ProgressInfo,
    RandomSearch,
    Target,
    Uniform,
    VariableTarget,
    WalkerInit,
    chain_to_dataframe,
    progress,
    target_from_dataframe,
)

# ``import <this package>.progress`` resolves, as ``rscm.calibrate.progress``
# does in the reference
_sys.modules[__name__ + ".progress"] = progress


class Optimizer:
    """Enum-style optimizer selection matching the reference
    (``optimizer.rs``: only RandomSearch existed there; the port also
    provides gradient-based optimizers via rscm_tpu_torch.calibrate)."""

    RandomSearch = RandomSearch()

    @staticmethod
    def random_search(seed=None):
        return RandomSearch(seed)


__all__ = [
    "HAS_PANDAS",
    "Bound",
    "Chain",
    "CompiledModelRunner",
    "DefaultModelRunner",
    "EnsembleSampler",
    "GaussianLikelihood",
    "LogNormal",
    "ModelRunner",
    "Normal",
    "Observation",
    "OptimizationResult",
    "Optimizer",
    "ParameterSet",
    "PointEstimator",
    "ProgressInfo",
    "RandomSearch",
    "Target",
    "Uniform",
    "VariableTarget",
    "WalkerInit",
    "chain_to_dataframe",
    "progress",
    "target_from_dataframe",
]
