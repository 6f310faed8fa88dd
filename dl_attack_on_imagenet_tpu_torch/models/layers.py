"""Shared victim building blocks.

Attacks work in [0, 1] pixel space; the ImageNet mean/std shift lives inside
the victim so that gradients flow through it. Port of
``dl_attack_on_imagenet_tpu/models/layers.py``, over NCHW views: the
normalization and torchvision's ``transform_input`` affine (both tiled over
the channels of a space-to-depth input), the space-to-depth layout of the
S2D stems, the conv -> BN -> ReLU block and the max pool with the JAX
package's padding rules. The JAX package's environment-selected backward
passes of the max pool and the ReLU (``ADIL_MAXPOOL``, ``ADIL_RELU``)
compute the same gradients with other memory traffic and are not ported.
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


def _tiled(buf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (1, 3, 1, 1) channel buffer tiled over ``x``'s channels: a
    space-to-depth input has 12, in the order (ki, kj, c) with c fastest."""
    reps = x.shape[1] // buf.shape[1]
    return buf if reps == 1 else buf.repeat(1, reps, 1, 1)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC -> blocked NHWC: (N, H, W, C) -> (N, H/b, W/b, b*b*C), channel
    order (ki, kj, c) with c fastest: the S2D stems' compute layout, and
    the JAX package's ``space_to_depth``. The result is contiguous."""
    n, h, w, c = x.shape
    xb = x.reshape(n, h // block, block, w // block, block, c)
    return xb.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block, block * block * c)


def depth_to_space(xb: torch.Tensor, block: int = 2) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    n, hb, wb, cb = xb.shape
    c = cb // (block * block)
    x = xb.reshape(n, hb, wb, block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, hb * block, wb * block, c)


def space_to_depth_nchw(x: torch.Tensor) -> torch.Tensor:
    """:func:`space_to_depth` of an NCHW view (channels_last in memory, as
    the victims' inputs are), as an NCHW view of the blocked tensor."""
    return space_to_depth(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Normalize(nn.Module):
    """Channel normalization ``(x - mean) / std`` of NCHW images, in the
    input's dtype (mean and std are cast to it), as the JAX wrapper
    normalizes a bf16 input in bf16; tiled over a space-to-depth input's
    channels."""

    def __init__(self, mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD):
        super().__init__()
        self.register_buffer("mean", _channel_buffer(mean), persistent=False)
        self.register_buffer("std", _channel_buffer(std), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - _tiled(self.mean, x).to(x.dtype)) / _tiled(self.std, x).to(x.dtype)


class TransformInput(nn.Module):
    """torchvision's ``transform_input=True`` channel affine,
    ``x_c * (std_c / 0.5) + (mean_c - 0.5) / 0.5`` (the JAX package's
    ``torch_transform_input``). GoogLeNet and Inception-v3 apply it inside
    their forward, on top of the victim's ``Normalize``; tiled over a
    space-to-depth input's channels."""

    def __init__(self):
        super().__init__()
        self.register_buffer("scale", _channel_buffer(IMAGENET_STD) / 0.5, persistent=False)
        self.register_buffer("shift", (_channel_buffer(IMAGENET_MEAN) - 0.5) / 0.5,
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * _tiled(self.scale, x) + _tiled(self.shift, x)


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
