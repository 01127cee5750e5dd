"""``rscm.two_layer`` — the Held et al. (2010) two-layer energy-balance
component, resolved to the port's implementation (the reference binds this
name to its Rust component)."""

from rscm_tpu_torch.components import TwoLayerBuilder

__all__ = ["TwoLayerBuilder"]
