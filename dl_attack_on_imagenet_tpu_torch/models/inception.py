"""Inception-v3 as a torchvision-shaped module.

Port of ``dl_attack_on_imagenet_tpu/models/inception.py``: every conv ->
BN -> ReLU is torchvision's ``BasicConv2d`` with BatchNorm eps 1e-3;
``transform_input=True`` by default; VALID stem convolutions and pools,
asymmetric 1x7 and 7x1 kernels, and 3x3/s1 "SAME" average pools that count
the zero padding (flax's default, and torchvision's). Global average
pooling makes the head size-agnostic: 299 is the registry size, 224 the
CLI's (``blanket_input_size``), 75 the smallest input. No auxiliary head
(eval-mode victims). The names are torchvision's, so its ``state_dict``
loads once ``AuxLogits.*`` is dropped (``convert.load_torch_checkpoint``).
``dtype=`` is the compute dtype, as for the ResNets.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BasicConv2d, Linear, TransformInput, avg_pool, global_avg_pool, max_pool,
                     set_compute_dtype)

_conv = functools.partial(BasicConv2d, eps=1e-3)


class _AvgPool3x3(torch.autograd.Function):
    """3x3/s1 average pool over one pixel of zero padding, counted in the
    mean. The pool is its own adjoint (a symmetric stencil over zero
    padding), so the backward pass runs the forward kernel on the gradient:
    PyTorch's CUDA backward of ``avg_pool2d`` with padding returns wrong
    gradients for a channels_last tensor of side 2 or more (errors of order
    the gradient itself; measured on an H100 with torch 2.11 and CUDA 12.8,
    where its NCHW backward and its forward are right)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(grad, 3, stride=1, padding=1, count_include_pad=True)


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    """The 3x3/s1 "SAME" average pool: :class:`_AvgPool3x3` in fp32 (an
    fp32 victim runs in NCHW, where PyTorch's backward is right, but its
    net can be moved to channels_last); a bf16 tensor sums its taps in bf16
    (``layers.avg_pool``), which uses no ``avg_pool2d`` backward."""
    if x.dtype == torch.float32:
        return _AvgPool3x3.apply(x)
    return avg_pool(x, 3, 1, "SAME")


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return max_pool(x, 3, 2, "VALID")


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = _conv(cin, 64, 1)
        self.branch5x5_1 = _conv(cin, 48, 1)
        self.branch5x5_2 = _conv(48, 64, 5)
        self.branch3x3dbl_1 = _conv(cin, 64, 1)
        self.branch3x3dbl_2 = _conv(64, 96, 3)
        self.branch3x3dbl_3 = _conv(96, 96, 3)
        self.branch_pool = _conv(cin, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b2, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = _conv(cin, 384, 3, stride=2, padding=0)
        self.branch3x3dbl_1 = _conv(cin, 64, 1)
        self.branch3x3dbl_2 = _conv(64, 96, 3)
        self.branch3x3dbl_3 = _conv(96, 96, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), b2, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = _conv(cin, 192, 1)
        self.branch7x7_1 = _conv(cin, c7, 1)
        self.branch7x7_2 = _conv(c7, c7, (1, 7))
        self.branch7x7_3 = _conv(c7, 192, (7, 1))
        self.branch7x7dbl_1 = _conv(cin, c7, 1)
        self.branch7x7dbl_2 = _conv(c7, c7, (7, 1))
        self.branch7x7dbl_3 = _conv(c7, c7, (1, 7))
        self.branch7x7dbl_4 = _conv(c7, c7, (7, 1))
        self.branch7x7dbl_5 = _conv(c7, 192, (1, 7))
        self.branch_pool = _conv(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        b3 = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            b3 = getattr(self, f"branch7x7dbl_{i}")(b3)
        return torch.cat([self.branch1x1(x), b2, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = _conv(cin, 192, 1)
        self.branch3x3_2 = _conv(192, 320, 3, stride=2, padding=0)
        self.branch7x7x3_1 = _conv(cin, 192, 1)
        self.branch7x7x3_2 = _conv(192, 192, (1, 7))
        self.branch7x7x3_3 = _conv(192, 192, (7, 1))
        self.branch7x7x3_4 = _conv(192, 192, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch3x3_2(self.branch3x3_1(x))
        b2 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b2 = getattr(self, f"branch7x7x3_{i}")(b2)
        return torch.cat([b1, b2, _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = _conv(cin, 320, 1)
        self.branch3x3_1 = _conv(cin, 384, 1)
        self.branch3x3_2a = _conv(384, 384, (1, 3))
        self.branch3x3_2b = _conv(384, 384, (3, 1))
        self.branch3x3dbl_1 = _conv(cin, 448, 1)
        self.branch3x3dbl_2 = _conv(448, 384, 3)
        self.branch3x3dbl_3a = _conv(384, 384, (1, 3))
        self.branch3x3dbl_3b = _conv(384, 384, (3, 1))
        self.branch_pool = _conv(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = self.branch3x3_1(x)
        b2 = torch.cat([self.branch3x3_2a(b2), self.branch3x3_2b(b2)], 1)
        b3 = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        b3 = torch.cat([self.branch3x3dbl_3a(b3), self.branch3x3dbl_3b(b3)], 1)
        return torch.cat([self.branch1x1(x), b2, b3, self.branch_pool(_avg_pool(x))], 1)


class Inception3(nn.Module):
    """Inception-v3 over NCHW input; logits out."""

    def __init__(self, num_classes: int = 1000, transform_input: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.transform = TransformInput() if transform_input else None
        self.Conv2d_1a_3x3 = _conv(3, 32, 3, stride=2, padding=0)
        self.Conv2d_2a_3x3 = _conv(32, 32, 3, padding=0)
        self.Conv2d_2b_3x3 = _conv(32, 64, 3)
        self.Conv2d_3b_1x1 = _conv(64, 80, 1, padding=0)
        self.Conv2d_4a_3x3 = _conv(80, 192, 3, padding=0)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = Linear(2048, num_classes)
        self.num_classes = num_classes
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transform is not None:
            x = self.transform(x)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return self.fc(global_avg_pool(x))


def inception_v3(num_classes: int = 1000, transform_input: bool = True,
                 dtype: torch.dtype = torch.float32) -> Inception3:
    return Inception3(num_classes=num_classes, transform_input=transform_input, dtype=dtype)
