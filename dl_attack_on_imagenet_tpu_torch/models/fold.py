"""Fold frozen BatchNorms into the convolutions before them (exact for
eval-mode victims).

Port of ``dl_attack_on_imagenet_tpu/models/fold.py``. A victim is always in
eval mode, so each BatchNorm is a fixed per-channel affine map and folds
into the preceding convolution: ``weight' = weight * s`` and
``bias' = (bias - mean) * s + beta`` with ``s = gamma / sqrt(var + eps)``.
Each BatchNorm's own ``eps`` is used, which is the per-model eps of the JAX
package (1e-5 for the ResNets and MobileNetV2, 1e-3 for GoogLeNet and
Inception-v3). The folded victim skips one elementwise pass over every
activation, forward and backward.

Only conv -> BN victims fold: the ResNets, GoogLeNet, Inception-v3 and
MobileNetV2. DenseNet is pre-activation (BN -> ReLU -> conv), so the ReLU
between a BatchNorm and the next convolution blocks the fold; VGG and ViT
have no BatchNorm.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Normalize


_FOLDABLE = ("resnet", "googlenet", "inception", "mobilenet")


def foldable(name: str) -> bool:
    """Whether the registry's victim ``name`` has a folded form."""
    return name.lower().startswith(_FOLDABLE)


@torch.no_grad()
def fold_batchnorms_(net: nn.Module) -> nn.Module:
    """Fold every BatchNorm2d of ``net`` into the Conv2d registered just
    before it (the conv -> BN order of every block), in place: the
    convolution's weight is scaled, it gains a bias, and the BatchNorm
    becomes an ``nn.Identity``. Returns ``net``."""
    pairs, conv = [], None
    for name, mod in net.named_modules():
        if isinstance(mod, nn.Conv2d):
            conv = mod
        elif isinstance(mod, nn.BatchNorm2d):
            if conv is None:
                raise ValueError(f"BatchNorm {name} follows no convolution")
            pairs.append((name, conv, mod))
            conv = None
    for name, conv, bn in pairs:
        s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        pre = conv.bias if conv.bias is not None else torch.zeros_like(s)
        conv.weight.mul_(s.reshape(-1, 1, 1, 1))
        conv.bias = nn.Parameter((pre - bn.running_mean) * s + bn.bias,
                                 requires_grad=conv.weight.requires_grad)
        parent, _, attr = name.rpartition(".")
        setattr(net.get_submodule(parent), attr, nn.Identity())
    return net


def fold_victim(victim, normalize=None):
    """Fold ``victim``'s BatchNorms into its convolutions, in place, and
    return it; its logits match the unfolded ones to fp32 rounding. The
    fold is in fp32; a bf16 victim casts the folded weights at each
    convolution, as the JAX package's folded bf16 victim does. Raises
    ``ValueError`` for a victim with no folded form. ``normalize``, as in
    the JAX package, keeps the victim's normalization where None and
    otherwise turns it on (with the victim's mean and std) or off."""
    if not foldable(victim.name):
        raise ValueError(f"model '{victim.name}' has no folded form")
    fold_batchnorms_(victim.net)
    if normalize is not None and normalize != (victim.norm is not None):
        victim.norm = Normalize(victim.mean, victim.std).to(victim.device) if normalize else None
    return victim
