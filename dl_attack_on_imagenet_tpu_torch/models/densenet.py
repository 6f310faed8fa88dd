"""DenseNet family (121/169) as torchvision-shaped modules.

Port of ``dl_attack_on_imagenet_tpu/models/densenet.py``. ``stem_s2d`` runs
the 7x7/s2 stem on 2x2 space-to-depth blocks, as the ResNets do
(``resnet.s2d_stem``), on the same ``conv0`` kernel, with the stem's ReLU
after its max pool. Each dense layer is
pre-activation, BN -> ReLU -> 1x1 conv -> BN -> ReLU -> 3x3 conv, and
concatenates its output to its input; a transition is BN -> ReLU -> 1x1
conv -> 2x2 average pool. The names are torchvision's
(``features.denseblock1.denselayer1.norm1``, ``features.transition1.conv``,
``classifier``), so a torchvision ``state_dict`` loads as it is. A BatchNorm
comes before its convolution here, so DenseNet has no folded form.
``dtype=`` is the compute dtype, as for the ResNets.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
from torch import nn

from .layers import (Conv2d, Linear, MaxPool, ReLU, avg_pool, global_avg_pool, relu,
                     set_compute_dtype)
from .resnet import s2d_stem, stem_blocks


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(cin)
        self.conv1 = Conv2d(cin, bn_size * growth_rate, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(bn_size * growth_rate)
        self.conv2 = Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(relu(self.norm1(x)))
        y = self.conv2(relu(self.norm2(y)))
        return torch.cat([x, y], 1)


class Transition(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(cin)
        self.conv = Conv2d(cin, cout, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool(self.conv(relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """DenseNet over NCHW input; logits out."""

    def __init__(self, block_config: Sequence[int], growth_rate: int = 32,
                 num_init_features: int = 64, num_classes: int = 1000,
                 stem_s2d: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem_s2d = stem_s2d
        layers = OrderedDict([
            ("conv0", Conv2d(3, num_init_features, 7, stride=2, padding=3, bias=False)),
            ("norm0", nn.BatchNorm2d(num_init_features)),
            ("relu0", ReLU()),
            ("pool0", MaxPool(3, 2, ((1, 1), (1, 1)))),
        ])
        features = num_init_features
        for i, num_layers in enumerate(block_config):
            block = OrderedDict()
            for j in range(num_layers):
                block[f"denselayer{j + 1}"] = DenseLayer(features, growth_rate)
                features += growth_rate
            layers[f"denseblock{i + 1}"] = nn.Sequential(block)
            if i != len(block_config) - 1:
                layers[f"transition{i + 1}"] = Transition(features, features // 2)
                features //= 2
        layers["norm5"] = nn.BatchNorm2d(features)
        self.features = nn.Sequential(layers)
        self.classifier = Linear(features, num_classes)
        self.num_classes = num_classes
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xb = stem_blocks(x, self.stem_s2d)
        if xb is None:
            x = self.features(x)
        else:
            f = self.features
            x = relu(f.pool0(s2d_stem(xb, f.conv0, f.norm0)))
            for name, mod in f.named_children():
                if name not in ("conv0", "norm0", "relu0", "pool0"):
                    x = mod(x)
        return self.classifier(global_avg_pool(relu(x)))


def densenet121(num_classes: int = 1000, stem_s2d: bool = False,
                dtype: torch.dtype = torch.float32) -> DenseNet:
    return DenseNet([6, 12, 24, 16], num_classes=num_classes, stem_s2d=stem_s2d, dtype=dtype)


def densenet169(num_classes: int = 1000, stem_s2d: bool = False,
                dtype: torch.dtype = torch.float32) -> DenseNet:
    return DenseNet([6, 12, 32, 32], num_classes=num_classes, stem_s2d=stem_s2d, dtype=dtype)
