"""ResNet family (18/34/50) as torchvision-shaped modules.

Port of ``dl_attack_on_imagenet_tpu/models/resnet.py`` without its TPU
layout knobs (space-to-depth stem, blocked input); ``models/fold.py`` folds
the BatchNorms of a built one. The module and parameter names are
torchvision's, so a torchvision ``state_dict`` loads as it is. BatchNorm is
frozen in eval mode (eps 1e-5); the stem applies its ReLU before the max
pool, as torchvision does, where the JAX package applies it after: both
orders give the same function.
"""

from __future__ import annotations

from typing import List, Type, Union

import torch
from torch import nn


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU()
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
        self.relu = nn.ReLU()
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

    def __init__(self, stage_sizes: List[int], block: Block, num_classes: int = 1000):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
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
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(inplanes, num_classes)
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(torch.flatten(self.avgpool(x), 1))


def resnet18(num_classes: int = 1000) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes)


def resnet34(num_classes: int = 1000) -> ResNet:
    return ResNet([3, 4, 6, 3], BasicBlock, num_classes)


def resnet50(num_classes: int = 1000) -> ResNet:
    return ResNet([3, 4, 6, 3], Bottleneck, num_classes)
