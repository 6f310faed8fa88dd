"""GoogLeNet (Inception v1) as a torchvision-shaped module.

Port of ``dl_attack_on_imagenet_tpu/models/googlenet.py``. ``stem_s2d`` runs
the 7x7/s2 stem on 2x2 space-to-depth blocks, as the ResNets do
(``resnet.s2d_stem``), on the same ``conv1`` kernel and BatchNorm (eps
1e-3), with the stem's ReLU after its max pool. As there: every conv -> BN
-> ReLU is torchvision's ``BasicConv2d`` with BatchNorm eps 1e-3;
``transform_input=True`` by default (torchvision's pretrained setting); the
"5x5" branch is a 3x3, as torchvision's weights are shaped; the max pools
are the JAX package's "SAME" pools (-inf padding, the odd pixel at the
bottom and right), which are torchvision's ``ceil_mode=True`` pools at 224;
no auxiliary heads (a victim runs in eval mode, where torchvision skips
them too). The names are torchvision's, so its ``state_dict`` loads once
``aux1.*`` and ``aux2.*`` are dropped (``convert.load_torch_checkpoint``
does). ``dtype=`` is the compute dtype, as for the ResNets;
``transform_input`` runs in the input's dtype, before the first convolution
casts it.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from .layers import (BasicConv2d, Linear, MaxPool, TransformInput, global_avg_pool, relu,
                     set_compute_dtype)
from .resnet import s2d_stem, stem_blocks

_BN_EPS = 1e-3  # torchvision BasicConv2d: BatchNorm2d(out_channels, eps=0.001)
_conv = functools.partial(BasicConv2d, eps=_BN_EPS)


class Inception(nn.Module):
    def __init__(self, cin: int, c1: int, c3r: int, c3: int, c5r: int, c5: int, pool_proj: int):
        super().__init__()
        self.branch1 = _conv(cin, c1, 1)
        self.branch2 = nn.Sequential(_conv(cin, c3r, 1), _conv(c3r, c3, 3))
        self.branch3 = nn.Sequential(_conv(cin, c5r, 1), _conv(c5r, c5, 3))
        self.branch4 = nn.Sequential(MaxPool(3, 1, "SAME"), _conv(cin, pool_proj, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x),
                          self.branch4(x)], 1)


class GoogLeNet(nn.Module):
    """GoogLeNet over NCHW input; logits out."""

    def __init__(self, num_classes: int = 1000, transform_input: bool = True,
                 stem_s2d: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem_s2d = stem_s2d
        self.transform = TransformInput() if transform_input else None
        self.conv1 = _conv(3, 64, 7, stride=2)
        self.maxpool1 = MaxPool(3, 2)
        self.conv2 = _conv(64, 64, 1)
        self.conv3 = _conv(64, 192, 3)
        self.maxpool2 = MaxPool(3, 2)
        self.inception3a = Inception(192, 64, 96, 128, 16, 32, 32)
        self.inception3b = Inception(256, 128, 128, 192, 32, 96, 64)
        self.maxpool3 = MaxPool(3, 2)
        self.inception4a = Inception(480, 192, 96, 208, 16, 48, 64)
        self.inception4b = Inception(512, 160, 112, 224, 24, 64, 64)
        self.inception4c = Inception(512, 128, 128, 256, 24, 64, 64)
        self.inception4d = Inception(512, 112, 144, 288, 32, 64, 64)
        self.inception4e = Inception(528, 256, 160, 320, 32, 128, 128)
        self.maxpool4 = MaxPool(2, 2)
        self.inception5a = Inception(832, 256, 160, 320, 32, 128, 128)
        self.inception5b = Inception(832, 384, 192, 384, 48, 128, 128)
        self.fc = Linear(1024, num_classes)
        self.num_classes = num_classes
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transform is not None:
            x = self.transform(x)
        xb = stem_blocks(x, self.stem_s2d)
        if xb is None:
            x = self.maxpool1(self.conv1(x))
        else:
            x = relu(self.maxpool1(s2d_stem(xb, self.conv1.conv, self.conv1.bn)))
        x = self.maxpool2(self.conv3(self.conv2(x)))
        x = self.maxpool3(self.inception3b(self.inception3a(x)))
        for name in ("4a", "4b", "4c", "4d", "4e"):
            x = getattr(self, f"inception{name}")(x)
        x = self.inception5b(self.inception5a(self.maxpool4(x)))
        return self.fc(global_avg_pool(x))


def googlenet(num_classes: int = 1000, transform_input: bool = True,
              stem_s2d: bool = False, dtype: torch.dtype = torch.float32) -> GoogLeNet:
    return GoogLeNet(num_classes=num_classes, transform_input=transform_input,
                     stem_s2d=stem_s2d, dtype=dtype)
