"""ResNet family (18/34/50) as torchvision-shaped modules.

Port of ``dl_attack_on_imagenet_tpu/models/resnet.py``; ``models/fold.py``
folds the BatchNorms of a built one. The module and parameter names are
torchvision's, so a torchvision ``state_dict`` loads as it is. BatchNorm is
frozen in eval mode (eps 1e-5).

``stem_s2d=True`` runs the 7x7/s2 stem convolution as the JAX package's
``S2DStem`` does (:func:`s2d_stem`): on the 2x2 space-to-depth blocks of the
input, as a 4x4/s1 convolution over 4x the channels. The parameter stays the
plain ``conv1`` kernel, so weights, checkpoints and the fold are those of
the plain stem. An odd input size falls back to the plain stem.
The plain stem applies its ReLU before the max pool, as torchvision does;
the S2D stem after it, as the JAX package does (the ReLU then runs at a
quarter of the size). Both orders give the same values and, since the pool
routes a gradient to its window's maximum and a ReLU of a non-positive
maximum passes none, the same input gradients.

``dtype=torch.bfloat16`` computes every convolution and the classifier in
bf16 over fp32 parameters, and each BatchNorm in fp32 on the bf16
activation, rounding its result to bf16, as the JAX package's
``dtype=jnp.bfloat16`` does (``layers``); the logits are bf16.
"""

from __future__ import annotations

from typing import List, Type, Union

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv2d, Linear, MaxPool, ReLU, global_avg_pool, relu, set_compute_dtype,
                     space_to_depth_nchw)


def _blocked_kernel(weight: torch.Tensor) -> torch.Tensor:
    """The (F, 4C, 4, 4) kernel over 2x2 blocks of a (F, C, 7, 7) stride-2
    kernel with padding 3: output o reads input rows 2o + a - 3 (a = 0..6),
    which is block row o + q - 2 at parity k with a + 1 = 2q + k, so a zero
    tap in front of the 7 makes 4 blocks of 2. Channels are (ki, kj, c)
    with c fastest, the order of ``space_to_depth``. The kernel keeps
    ``weight``'s memory layout, channels_last or contiguous, as the
    victim's other convolutions do."""
    f, c = weight.shape[:2]
    w = F.pad(weight, (1, 0, 1, 0)).reshape(f, c, 4, 2, 4, 2)  # (f, c, qi, ki, qj, kj)
    w = w.permute(0, 3, 5, 1, 2, 4).reshape(f, 4 * c, 4, 4)
    if weight.is_contiguous(memory_format=torch.channels_last):
        return w.contiguous(memory_format=torch.channels_last)
    return w


def s2d_stem(xb: torch.Tensor, conv: nn.Conv2d, bn: nn.Module) -> torch.Tensor:
    """``bn(conv(x))`` of a 7x7/s2, padding-3 ``conv`` (the JAX package's
    ``S2DStem`` without its ReLU), computed on ``xb``, the 2x2 space-to-depth
    NCHW view of x. The blocked kernel is built from ``conv.weight`` once
    per weight version (a load or a fold makes a new one) and kept on the
    convolution. The padding is ((2, 1), (2, 1)) in blocks, which
    ``F.conv2d`` cannot express, so it is applied first. With the
    convolution's ``compute_dtype`` set, the blocks and the kernel are cast
    to it and a folded bias is added after the convolution, as in
    ``layers.Conv2d``."""
    w = conv.weight
    key = (w.data_ptr(), w._version, w.device, w.dtype)
    cached = conv.__dict__.get("_s2d_kernel")
    if cached is not None and cached[0] == key:
        kb = cached[1]
    else:
        kb = _blocked_kernel(w)
        if not w.requires_grad:
            conv.__dict__["_s2d_kernel"] = (key, kb)
    dt = getattr(conv, "compute_dtype", None)
    if dt is None:
        return bn(F.conv2d(F.pad(xb, (2, 1, 2, 1)), kb, conv.bias))
    y = F.conv2d(F.pad(xb.to(dt), (2, 1, 2, 1)), kb.to(dt))
    if conv.bias is not None:
        y = y + conv.bias.to(dt).reshape(-1, 1, 1)
    return bn(y)


def stem_blocks(x: torch.Tensor, stem_s2d: bool):
    """The blocked view the S2D stem runs on, or None for the plain stem:
    ``x``'s space-to-depth where ``stem_s2d`` and the size is even."""
    if stem_s2d and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
        return space_to_depth_nchw(x)
    return None


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = nn.BatchNorm2d(planes)
        self.relu = ReLU()
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(_conv(inplanes, planes, 1, stride),
                                            nn.BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = nn.BatchNorm2d(out)
        self.relu = ReLU()
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(_conv(inplanes, out, 1, stride),
                                            nn.BatchNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


Block = Type[Union[BasicBlock, Bottleneck]]


class ResNet(nn.Module):
    """ResNet over NCHW input; logits out."""

    def __init__(self, stage_sizes: List[int], block: Block, num_classes: int = 1000,
                 stem_s2d: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem_s2d = stem_s2d
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = ReLU()
        self.maxpool = MaxPool(3, 2, ((1, 1), (1, 1)))
        inplanes = 64
        for i, size in enumerate(stage_sizes):
            planes = 64 * 2**i
            blocks = []
            for j in range(size):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(inplanes, planes, stride))
                inplanes = planes * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.fc = Linear(inplanes, num_classes)
        self.num_classes = num_classes
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xb = stem_blocks(x, self.stem_s2d)
        if xb is None:
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        else:
            x = relu(self.maxpool(s2d_stem(xb, self.conv1, self.bn1)))
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(global_avg_pool(x))


def resnet18(num_classes: int = 1000, stem_s2d: bool = False,
             dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes, stem_s2d, dtype)


def resnet34(num_classes: int = 1000, stem_s2d: bool = False,
             dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet([3, 4, 6, 3], BasicBlock, num_classes, stem_s2d, dtype)


def resnet50(num_classes: int = 1000, stem_s2d: bool = False,
             dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet([3, 4, 6, 3], Bottleneck, num_classes, stem_s2d, dtype)
