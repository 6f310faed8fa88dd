"""PyTorch/CUDA port of ``dl_attack_on_imagenet_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package keeps its
module names, its NHWC image layout and its atoms-first ``(K, H*W*C)``
dictionary layout, so each function has a counterpart there. It imports
``torch`` and nothing of JAX or of the JAX package.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` argument they take ``cuda`` and raise where there is none.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is named.

    Raises where CUDA is named or implied and absent, rather than falling
    back to the CPU: a CPU run has to be asked for with ``device="cpu"``.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


__all__ = ["resolve_device"]
