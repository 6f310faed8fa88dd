"""Fold frozen BatchNorms into the convolutions before them (exact for
eval-mode victims).

Port of ``dl_attack_on_imagenet_tpu/models/fold.py``. A victim is always in
eval mode, so each BatchNorm is a fixed per-channel affine map and folds
into the preceding convolution: ``weight' = weight * s`` and
``bias' = (bias - mean) * s + beta`` with ``s = gamma / sqrt(var + eps)``.
Each BatchNorm's own ``eps`` is used, which is the per-model eps of the JAX
package (1e-5 for the ResNets). The folded victim skips one elementwise
pass over every activation, forward and backward.
"""

from __future__ import annotations

import torch
from torch import nn


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


def fold_victim(victim):
    """Fold ``victim``'s BatchNorms into its convolutions, in place, and
    return it; its logits match the unfolded ones to fp32 rounding."""
    fold_batchnorms_(victim.net)
    return victim
