"""Shared victim building blocks.

Attacks work in [0, 1] pixel space; the ImageNet mean/std shift lives inside
the victim so that gradients flow through it. Port of the parts of
``dl_attack_on_imagenet_tpu/models/layers.py`` that the victims use, over
NCHW views: the normalization, torchvision's ``transform_input`` affine, the
conv -> BN -> ReLU block and the max pool with the JAX package's padding
rules. The JAX package's TPU variants (space-to-depth, the custom max-pool
and ReLU backward passes) compute the same functions and are not ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Pair = Union[int, Tuple[int, int]]
Padding = Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _channel_buffer(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32).reshape(1, -1, 1, 1)


class Normalize(nn.Module):
    """Channel normalization ``(x - mean) / std`` of NCHW images, in the
    input's dtype (mean and std are cast to it), as the JAX wrapper
    normalizes a bf16 input in bf16."""

    def __init__(self, mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD):
        super().__init__()
        self.register_buffer("mean", _channel_buffer(mean), persistent=False)
        self.register_buffer("std", _channel_buffer(std), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)


class TransformInput(nn.Module):
    """torchvision's ``transform_input=True`` channel affine,
    ``x_c * (std_c / 0.5) + (mean_c - 0.5) / 0.5`` (the JAX package's
    ``torch_transform_input``). GoogLeNet and Inception-v3 apply it inside
    their forward, on top of the victim's ``Normalize``."""

    def __init__(self):
        super().__init__()
        self.register_buffer("scale", _channel_buffer(IMAGENET_STD) / 0.5, persistent=False)
        self.register_buffer("shift", (_channel_buffer(IMAGENET_MEAN) - 0.5) / 0.5,
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale + self.shift


class BasicConv2d(nn.Module):
    """Conv (no bias) -> frozen BatchNorm -> ReLU, the JAX package's
    ``ConvBN`` under torchvision's ``BasicConv2d`` names (``conv``, ``bn``),
    with the BatchNorm's own ``eps``.

    ``padding=None`` is the JAX package's "TORCH" rule, symmetric ``k // 2``
    on each side of each dimension, so a (1, 7) kernel pads (0, 3); pass 0
    for "VALID". The conv is registered before its BatchNorm, the order
    ``models.fold`` pairs them in. (MobileNetV2's grouped conv -> BN ->
    ReLU6 block is ``mobilenet.ConvBNReLU6``, under torchvision's names
    for it.)
    """

    def __init__(self, cin: int, cout: int, kernel: Pair, stride: Pair = 1,
                 padding: Pair = None, eps: float = 1e-5):
        super().__init__()
        kh, kw = _pair(kernel)
        if padding is None:
            padding = (kh // 2, kw // 2)
        self.conv = nn.Conv2d(cin, cout, (kh, kw), stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def pool_pads(h: int, w: int, window: Pair, strides: Pair,
              padding: Padding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) padding of a pool, the JAX package's
    ``_pool_pads``: none for "VALID"; for "SAME", XLA's rule, which puts the
    odd pixel at the bottom and right; explicit pads as given."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        out = []
        for size, k, s in zip((h, w), _pair(window), _pair(strides)):
            n_out = -(-size // s)
            total = max((n_out - 1) * s + k - size, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    return tuple(tuple(p) for p in padding)


def max_pool(x: torch.Tensor, window: Pair, strides: Pair, padding: Padding = "SAME") -> torch.Tensor:
    """Max pool of an NCHW tensor with the JAX package's padding (padded
    pixels are -inf). Symmetric pads go to ``F.max_pool2d`` as they are;
    "SAME"'s asymmetric ones (a 3x3/s2 pool at 112 pads (0, 1)) are padded
    first. At 224 this is torchvision's ``ceil_mode=True``, not at every
    size: the port follows the JAX package."""
    window, strides = _pair(window), _pair(strides)
    (top, bottom), (left, right) = pool_pads(x.shape[2], x.shape[3], window, strides, padding)
    if top == bottom <= window[0] // 2 and left == right <= window[1] // 2:
        return F.max_pool2d(x, window, strides, padding=(top, left))
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, window, strides)


class MaxPool(nn.Module):
    """:func:`max_pool` as a module (no parameters)."""

    def __init__(self, window: Pair, strides: Pair, padding: Padding = "SAME"):
        super().__init__()
        self.window, self.strides, self.padding = window, strides, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(x, self.window, self.strides, self.padding)
