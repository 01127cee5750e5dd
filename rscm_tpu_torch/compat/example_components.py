"""Example components (reference surface)."""

from rscm_tpu_torch.core.example_components import TestComponent, TestComponentBuilder

__all__ = ["TestComponent", "TestComponentBuilder"]
