"""LS-Gaussian streaming renderer, ported to PyTorch + CUDA (Hopper).

Module for module this package mirrors ``repro`` (the JAX/Pallas
reference): ``repro_torch/core/camera.py`` ports ``repro/core/camera.py``
and so on. It imports ``torch`` and ``numpy`` only, never ``jax`` and
nothing of ``repro``.

Entry points run on the card unless the caller asks for the CPU: scene
and camera constructors take ``device="cuda"`` by default, everything
downstream follows the device of its input tensors, and with no GPU a
call that leaves ``device`` at its default raises instead of running on
the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run on the CPU")
    return dev
