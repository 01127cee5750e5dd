"""
Calibration: priors, targets, likelihoods, ensemble MCMC, point estimation.

Port of ``rscm_tpu/calibrate`` (itself a mirror of
``crates/rscm-calibrate``) for one CUDA card:

- the walkers of a posterior batch are the members of one batched run of
  the model's year loop (``CompiledModelRunner``), which goes through both
  CUDA kernels; the device engine of the ensemble sampler and NUTS loop
  over iterations with batched tensor operations on the card;
- gradients flow through the year loop and both kernels (their backward
  and forward-mode rules differentiate the kernels' plain PyTorch
  versions), in reverse mode and in forward mode, for gradient-based point
  estimation (Adam / BFGS), Laplace covariances, NUTS and sensitivities.

A host execution path (``EnsembleSampler`` with any user ``ModelRunner``)
keeps the reference's API and semantics for arbitrary Python models, with
the same numpy draws as the JAX package.
"""

from .distribution import Bound, Distribution, LogNormal, Normal, Uniform
from .parameter_set import ParameterSet
from .target import Observation, Target, VariableTarget
from .likelihood import GaussianLikelihood, LikelihoodFn, ModelOutput, VariableOutput
from .model_runner import (
    CompiledModelRunner,
    DefaultModelRunner,
    ModelRunner,
    SensitivityAnalyzer,
)
from .chain import Chain
from .sampler import (
    DEMove,
    EnsembleSampler,
    ProgressInfo,
    SamplerState,
    StretchMove,
    WalkerInit,
)
from .nuts import NUTSSampler
from .point_estimator import (
    AdamOptimizer,
    EstimateKind,
    LBFGSOptimizer,
    Optimizer,
    PointEstimate,
    PointEstimator,
    RandomSearch,
)

# pandas integration (graceful without pandas, mirroring the reference)
try:
    from .pandas_helpers import chain_to_dataframe, target_from_dataframe

    def _chain_to_dataframe(self, discard: int = 0):
        """Convert chain to a pandas DataFrame (walker/iteration index)."""
        return chain_to_dataframe(self, discard=discard)

    Chain.to_dataframe = _chain_to_dataframe
    Target.from_dataframe = staticmethod(target_from_dataframe)
    HAS_PANDAS = True
except ImportError:  # pragma: no cover
    HAS_PANDAS = False
    chain_to_dataframe = None
    target_from_dataframe = None

from . import progress  # noqa: E402

__all__ = [
    "Bound",
    "Chain",
    "CompiledModelRunner",
    "DefaultModelRunner",
    "Distribution",
    "EnsembleSampler",
    "EstimateKind",
    "GaussianLikelihood",
    "AdamOptimizer",
    "LBFGSOptimizer",
    "LikelihoodFn",
    "LogNormal",
    "ModelOutput",
    "ModelRunner",
    "NUTSSampler",
    "Normal",
    "Observation",
    "Optimizer",
    "ParameterSet",
    "PointEstimate",
    "PointEstimator",
    "ProgressInfo",
    "RandomSearch",
    "SamplerState",
    "SensitivityAnalyzer",
    "StretchMove",
    "DEMove",
    "Target",
    "Uniform",
    "VariableOutput",
    "VariableTarget",
    "WalkerInit",
]
