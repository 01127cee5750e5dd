"""Device choice for the port's entry points, and the anchor of a mesh.

The TPU package resolves *where a traced program will run* from a declared
execution target (``rscm_tpu/utils/target.py``).  PyTorch runs eagerly on
the device its tensors live on, so the port's counterpart is one rule for
the entry points (``Model.run``, ``EnsembleRunner``): they run on the CUDA
card unless the caller asks for another device, and a request for the
default device on a machine with no card raises instead of quietly running
on the CPU.  Components pick their engine from the device of the tensors
they are given, so the port needs no execution target.

A mesh (:class:`rscm_tpu_torch.parallel.Mesh`) lists the devices a batch is
split over; :func:`mesh_context` anchors the work that is not split (random
draws, the gathered results) to its first device.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__all__ = ["resolve_device", "mesh_platform", "mesh_context"]


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


def mesh_platform(mesh) -> str:
    """The device type of a mesh's devices (``"cuda"`` or ``"cpu"``)."""
    return mesh.devices[0].type


def device_guard(device):
    """A context in which ``device`` is the current CUDA device (a
    ``torch.cuda.device`` guard); for a device that is not a card, one that
    does nothing."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def mesh_context(mesh):
    """Anchor the work that is not split to the mesh's first device.

    On a CUDA anchor the block runs under ``torch.cuda.device(anchor)``, so
    ``"cuda"`` tensors, streams and generators made inside it belong to the
    anchor card; the port's code names the device of every tensor it makes,
    so that is all the anchor needs.  On a CPU anchor, and with
    ``mesh=None``, it does nothing.
    """
    return contextlib.nullcontext() if mesh is None else device_guard(mesh.devices[0])
