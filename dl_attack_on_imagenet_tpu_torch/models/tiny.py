"""Tiny CNN victim for fast CPU tests.

Port of ``dl_attack_on_imagenet_tpu/models/tiny.py``. Its convolutions use
Flax's "SAME" padding, which for a stride-2 3x3 conv is asymmetric ((0, 1)
on a 32-pixel side), so the padding is applied with ``F.pad`` from the input
size rather than with ``Conv2d(padding=...)``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA "SAME" along one spatial side."""
    n_out = -(-size // stride)
    total = max((n_out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Conv2d with "SAME" padding computed from the input size."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = same_pads(x.shape[2], self.kernel_size[0], self.stride[0])
        pw = same_pads(x.shape[3], self.kernel_size[1], self.stride[1])
        return super().forward(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))


class TinyCNN(nn.Module):
    def __init__(self, num_classes: int = 10, features: int = 8):
        super().__init__()
        self.conv0 = SameConv2d(3, features, 3, stride=2)
        self.conv1 = SameConv2d(features, features * 2, 3, stride=2)
        self.fc = nn.Linear(features * 2, num_classes)
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv0(x))
        x = F.relu(self.conv1(x))
        return self.fc(x.mean(dim=(2, 3)))


def tiny_cnn(num_classes: int = 10) -> TinyCNN:
    return TinyCNN(num_classes=num_classes)
