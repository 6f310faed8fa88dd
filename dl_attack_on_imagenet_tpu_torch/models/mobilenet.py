"""MobileNetV2 as a torchvision-shaped module.

Port of ``dl_attack_on_imagenet_tpu/models/mobilenet.py``: inverted
residuals with depthwise ``groups=hidden`` convolutions, BatchNorm eps
1e-5, ReLU6 (the JAX package's ReLU then ``min(., 6)``, here too). The
names are torchvision's (``features.1.conv.0.0``, ``classifier.1``), so a
torchvision ``state_dict`` loads as it is. ``dtype=`` is the compute dtype,
as for the ResNets.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv2d, Linear, global_avg_pool, relu, set_compute_dtype

# (expand_ratio, channels, num_blocks, stride)
_V2_CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU6(nn.Sequential):
    """torchvision's ``Conv2dNormActivation``: conv (``0``, symmetric
    ``k // 2`` padding) -> BatchNorm (``1``) -> ReLU6, the JAX package's
    ReLU capped by ``minimum(y, 6)`` (an exact tie at 6 splits its
    gradient, as ``jnp.minimum``'s does)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1):
        super().__init__(Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups,
                                bias=False),
                         nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = relu(super().forward(x))
        return torch.minimum(y, torch.full((), 6.0, dtype=y.dtype, device=y.device))


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = cin * expand_ratio
        layers = [ConvBNReLU6(cin, hidden, 1)] if expand_ratio != 1 else []
        layers += [ConvBNReLU6(hidden, hidden, 3, stride, groups=hidden),  # depthwise
                   Conv2d(hidden, cout, 1, bias=False),  # linear projection
                   nn.BatchNorm2d(cout)]
        self.conv = nn.Sequential(*layers)
        self.use_res_connect = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res_connect else y


class MobileNetV2(nn.Module):
    """MobileNetV2 over NCHW input; logits out."""

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = _make_divisible(32 * width_mult)
        layers = [ConvBNReLU6(3, cin, 3, 2)]
        for t, ch, n, s in _V2_CFG:
            cout = _make_divisible(ch * width_mult)
            for i in range(n):
                layers.append(InvertedResidual(cin, cout, s if i == 0 else 1, t))
                cin = cout
        last = _make_divisible(1280 * max(1.0, width_mult))
        layers.append(ConvBNReLU6(cin, last, 1))
        self.features = nn.Sequential(*layers)
        # torchvision's classifier is (Dropout, Linear); the dropout is the
        # identity in eval mode, the only mode of a victim.
        self.classifier = nn.Sequential(nn.Identity(), Linear(last, num_classes))
        self.num_classes = num_classes
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(global_avg_pool(self.features(x)))


def mobilenet_v2(num_classes: int = 1000, dtype: torch.dtype = torch.float32) -> MobileNetV2:
    return MobileNetV2(num_classes=num_classes, dtype=dtype)
