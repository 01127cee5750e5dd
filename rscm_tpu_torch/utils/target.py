"""Device choice for the port's entry points.

The TPU package resolves *where a traced program will run* from a declared
execution target (``rscm_tpu/utils/target.py``).  PyTorch runs eagerly on
the device its tensors live on, so the port's counterpart is one rule for
the entry points (``Model.run``, ``EnsembleRunner``): they run on the CUDA
card unless the caller asks for another device, and a request for the
default device on a machine with no card raises instead of quietly running
on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device a run uses: ``device`` if given, else the CUDA card.

    Raises ``RuntimeError`` when the run would need a CUDA card and none is
    available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
