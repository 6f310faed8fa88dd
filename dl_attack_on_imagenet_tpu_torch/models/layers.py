"""Shared victim building blocks.

Attacks work in [0, 1] pixel space; the ImageNet mean/std shift lives inside
the victim so that gradients flow through it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Normalize(nn.Module):
    """Channel normalization ``(x - mean) / std`` of NCHW images."""

    def __init__(self, mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD):
        super().__init__()
        as_buffer = lambda t: torch.tensor(t, dtype=torch.float32).reshape(1, -1, 1, 1)
        self.register_buffer("mean", as_buffer(mean), persistent=False)
        self.register_buffer("std", as_buffer(std), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.std
