"""ConvNeXt (ConvNeXt-B and a small one for tests) as torchvision-shaped
modules.

Liu et al. 2022, "A ConvNet for the 2020s" (arXiv:2201.03545), as
torchvision's ``convnext_base`` computes it in eval mode: a 4x4 stride-4
convolution and a LayerNorm over the channels (the stem), four stages of
blocks, and between stages a channel LayerNorm and a 2x2 stride-2
convolution that doubles the width; then the mean over the map, a
LayerNorm and the head. A block of width C is
``z + layer_scale * W2 GELU(W1 LN(dwconv7x7(z)) + b1) + b2``: a 7x7
depthwise convolution (padding 3, groups C, with a bias), a LayerNorm over
the channels at each pixel, the per-pixel Linears C -> 4C -> C with the
exact erf GELU between them, and the learned per-channel scale
``layer_scale`` of shape (C, 1, 1). LayerNorm eps is 1e-6; stochastic depth
is the identity (a victim is always in eval mode).

Layouts. The residual stream is a contiguous NCHW map, and every
convolution (the stem, each block's depthwise convolution, each
downsample) takes its input and weight in contiguous NCHW, the layout of
cuDNN's fp32 kernels and of the port's depthwise kernel
(``victim_memory_format``). The LayerNorms and the Linears run on NHWC
rows. The layout changes in three places: a block's NHWC half starts from
a permuted view of the depthwise output (the LayerNorm reads it into
contiguous NHWC rows) and ends in
``addcmul(z, layer_scale, m)`` on the NCHW view of its NHWC result, whose
output takes the layout of ``z``, contiguous NCHW; a channel LayerNorm
(:class:`LayerNorm2d`: the stem's, each downsample's and the head's)
permutes to NHWC, normalizes, and copies back to contiguous NCHW.

The names are torchvision's: ``features.0.{0,1}`` (the stem's convolution
and LayerNorm), ``features.{1,3,5,7}.i.{block.0, block.2, block.3,
block.5, layer_scale}`` (the depthwise convolution, the LayerNorm, the two
Linears, the scale), ``features.{2,4,6}.{0,1}`` (each downsample's
LayerNorm and convolution) and ``classifier.{0,2}`` (LayerNorm and head).

fp32 only: the port has no bf16 ConvNeXt (``dtype=torch.bfloat16``
raises).

Spans (``utils.profiling.annotate``, device-timed on the card): per block
``victim/convnext/dwconv`` (z -> the depthwise output h; its backward runs
from h's gradient to z's, the sum with the residual's gradient included:
on the card one launch of the kernel's backward)
and ``victim/convnext/mlp`` (h -> the block's output); per downsample
``victim/convnext/downsample``; ``victim/convnext/stem`` and
``victim/convnext/head`` (pool, LayerNorm and head) once a pass. Together
they tile a pass, forward and input gradient.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.kernels import convnext_dwconv
from ..utils.profiling import annotate
from .layers import Conv2d, Linear, resolve_dtype
from .swin import _Permute
from .vit import GELU, LayerNorm

_LN_EPS = 1e-6
_LAYER_SCALE = 1e-6  # torchvision's and the official code's initial value


class LayerNorm2d(LayerNorm):
    """A LayerNorm over the channels of an NCHW map at each pixel, in
    contiguous NCHW out (torchvision's ``LayerNorm2d``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2).contiguous()


class CNBlock(nn.Module):
    """torchvision's ``CNBlock`` in eval mode, on a contiguous NCHW map.

    On a CUDA map the depthwise convolution is the port's kernel
    (:func:`~..ops.kernels.convnext_dwconv`) with ``block.0``'s weight and
    bias, which also hands on z for the residual add, so that z's two
    gradients meet in its backward; elsewhere ``block.0`` itself computes
    it, as its twin :func:`~..ops.kernels.convnext_dwconv_reference`
    does."""

    def __init__(self, dim: int, kernel_size: int = 7, mlp_ratio: int = 4):
        super().__init__()
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), _LAYER_SCALE))
        self.block = nn.Sequential(
            Conv2d(dim, dim, kernel_size, padding=kernel_size // 2, groups=dim),
            _Permute((0, 2, 3, 1)), LayerNorm(dim, eps=_LN_EPS),
            Linear(dim, mlp_ratio * dim), GELU(), Linear(mlp_ratio * dim, dim),
            _Permute((0, 3, 1, 2)))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dwconv, to_nhwc, norm, fc1, act, fc2, to_nchw = self.block
        with annotate("victim/convnext/dwconv", device=z.is_cuda) as span:
            if z.is_cuda:
                h, residual = convnext_dwconv(z, dwconv.weight, dwconv.bias, dwconv.stride,
                                              dwconv.padding)
            else:
                h, residual = dwconv(z), z
            h = span.backward(z, h)
        with annotate("victim/convnext/mlp", device=z.is_cuda) as span:
            m = to_nchw(fc2(act(fc1(norm(to_nhwc(h))))))
            return span.backward(h, torch.addcmul(residual, self.layer_scale, m))


class Downsample(nn.Sequential):
    """A channel LayerNorm and a 2x2 stride-2 convolution to twice the
    width (torchvision's downsampling ``Sequential``)."""

    def __init__(self, dim: int):
        super().__init__(LayerNorm2d(dim, eps=_LN_EPS), Conv2d(dim, 2 * dim, 2, stride=2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("victim/convnext/downsample", device=x.is_cuda) as span:
            return span.backward(x, super().forward(x))


class ConvNeXt(nn.Module):
    """ConvNeXt over NCHW input; logits out."""

    def __init__(self, dims: Sequence[int] = (128, 256, 512, 1024),
                 depths: Sequence[int] = (3, 3, 27, 3), kernel_size: int = 7,
                 mlp_ratio: int = 4, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if resolve_dtype(dtype) != torch.float32:
            raise ValueError("ConvNeXt is built in float32 only; the port has no bf16 ConvNeXt")
        layers = [nn.Sequential(Conv2d(3, dims[0], 4, stride=4), LayerNorm2d(dims[0], eps=_LN_EPS))]
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            layers.append(nn.Sequential(*(CNBlock(dim, kernel_size, mlp_ratio)
                                          for _ in range(depth))))
            if i < len(dims) - 1:
                layers.append(Downsample(dim))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(LayerNorm2d(dims[-1], eps=_LN_EPS), nn.Flatten(1),
                                        Linear(dims[-1], num_classes))
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("victim/convnext/stem", device=x.is_cuda) as span:
            y = span.backward(x, self.features[0](x))
        for layer in self.features[1:]:
            y = layer(y)
        with annotate("victim/convnext/head", device=x.is_cuda) as span:
            return span.backward(y, self.classifier(y.mean(dim=(2, 3), keepdim=True)))


def convnext_b(num_classes: int = 1000, dtype: torch.dtype = torch.float32) -> ConvNeXt:
    """ConvNeXt-B: dims (128, 256, 512, 1024), depths (3, 3, 27, 3), 7x7
    depthwise kernels, MLP ratio 4 (torchvision's ``convnext_base``)."""
    return ConvNeXt(num_classes=num_classes, dtype=dtype)


def convnext_mini(num_classes: int = 1000, dtype: torch.dtype = torch.float32) -> ConvNeXt:
    """Small ConvNeXt for CPU tests: dims (16, 32, 64), depths (2, 1, 2);
    at 64² its maps are 16, 8 and 4 wide, so the last stage's 7x7 kernel
    reaches past its map on every side, as ConvNeXt-B's does at 7x7."""
    return ConvNeXt(dims=(16, 32, 64), depths=(2, 1, 2), num_classes=num_classes, dtype=dtype)
