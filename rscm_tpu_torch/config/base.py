"""Base configuration dataclasses (mirror of python/rscm/config/base.py:18-119)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = ["TimeConfig", "InputSpec", "ModelConfig"]


@dataclass
class TimeConfig:
    """Time axis configuration: inclusive start/end years."""

    start: int
    end: int

    def __post_init__(self):
        if self.end <= self.start:
            raise ValueError(
                f"end ({self.end}) must be greater than start ({self.start})"
            )

    def to_time_axis(self):
        return (self.start, self.end)


@dataclass
class InputSpec:
    """Input data specification: file path + unit + required flag."""

    file: Optional[str] = None
    unit: Optional[str] = None
    required: bool = False

    def is_complete(self) -> bool:
        return self.file is not None and self.unit is not None


@dataclass
class ModelConfig:
    """Base model configuration shared by all model types."""

    name: str
    model_type: str = ""
    version: str = "1.0.0"
    config_schema: str = "1.0.0"
    description: str = ""
    time: Optional[TimeConfig] = None
    inputs: Dict[str, InputSpec] = field(default_factory=dict)
    initial_values: Dict[str, float] = field(default_factory=dict)
