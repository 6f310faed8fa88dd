"""VGG family (11/16/19) as torchvision-shaped modules.

Port of ``dl_attack_on_imagenet_tpu/models/vgg.py``: 3x3 convolutions with
bias and ReLU, 2x2 VALID max pools, then the classifier on the features
flattened in (C, H, W) order. Away from a 7x7 feature map the JAX rule is an
average pool whose window and stride are ``floor(h / 7)`` (not
torchvision's adaptive pool), so the classifier's input width follows the
input size, and the module is built for one ``input_size``. The names are
torchvision's (``features.N``, ``classifier.0/3/6``); ``hidden`` is the
classifier's width (4096 in torchvision). ``dtype=`` is the compute
dtype, as for the ResNets.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import Conv2d, Linear, MaxPool, ReLU, avg_pool, set_compute_dtype

CFGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
              512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    """VGG over NCHW input of side ``input_size``; logits out."""

    def __init__(self, cfg: Sequence, num_classes: int = 1000, hidden: int = 4096,
                 input_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        layers, cin, side = [], 3, input_size
        for item in cfg:
            if item == "M":
                layers.append(MaxPool(2, 2, "VALID"))
                side //= 2
            else:
                layers += [Conv2d(cin, item, 3, padding=1), ReLU()]
                cin = item
        self.features = nn.Sequential(*layers)
        self.pool = 1 if side == 7 else max(side // 7, 1)
        side //= self.pool
        # torchvision's (Linear, ReLU, Dropout) x 2, Linear: the dropouts are
        # the identity in eval mode, the only mode of a victim.
        self.classifier = nn.Sequential(
            Linear(cin * side * side, hidden), ReLU(), nn.Identity(),
            Linear(hidden, hidden), ReLU(), nn.Identity(),
            Linear(hidden, num_classes))
        self.num_classes = num_classes
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        if self.pool > 1:
            x = avg_pool(x, self.pool, self.pool)
        return self.classifier(torch.flatten(x, 1))  # (C, H, W) order


def vgg11(num_classes: int = 1000, hidden: int = 4096, input_size: int = 224,
          dtype: torch.dtype = torch.float32) -> VGG:
    return VGG(CFGS["vgg11"], num_classes, hidden, input_size, dtype)


def vgg16(num_classes: int = 1000, hidden: int = 4096, input_size: int = 224,
          dtype: torch.dtype = torch.float32) -> VGG:
    return VGG(CFGS["vgg16"], num_classes, hidden, input_size, dtype)


def vgg19(num_classes: int = 1000, hidden: int = 4096, input_size: int = 224,
          dtype: torch.dtype = torch.float32) -> VGG:
    return VGG(CFGS["vgg19"], num_classes, hidden, input_size, dtype)
