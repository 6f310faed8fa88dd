"""Vision Transformer (ViT-B/16 and a tiny one for tests) as
torchvision-shaped modules.

Port of ``dl_attack_on_imagenet_tpu/models/vit.py``: a stride-16 patch
convolution (the JAX package's reshape + matmul is a TPU layout of the same
map, with the same weights), a class token, learned position embeddings
sized from ``input_size``, pre-norm encoder blocks with LayerNorm eps 1e-6
(flax's, and torchvision's ViT's), exact erf GELU, and the head on the
class token. Attention is written out in fp32, as flax computes it:
softmax(q k^T / sqrt(head_dim)) v, with q, k and v packed in
``in_proj_weight``. The names are torchvision's (``conv_proj``,
``class_token``, ``encoder.pos_embedding``,
``encoder.layers.encoder_layer_i.{ln_1, self_attention, ln_2, mlp.0,
mlp.3}``, ``encoder.ln``, ``heads.head``).
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
from torch import nn

_LN_EPS = 1e-6


class SelfAttention(nn.Module):
    """Multi-head self-attention under ``nn.MultiheadAttention``'s parameter
    names, computed without a fused kernel."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, length, dim = x.shape
        head_dim = dim // self.num_heads
        qkv = nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.view(n, length, 3, self.num_heads, head_dim).permute(2, 0, 3, 1, 4)
        weights = torch.softmax((q / math.sqrt(head_dim)) @ k.transpose(-2, -1), dim=-1)
        out = (weights @ v).transpose(1, 2).reshape(n, length, dim)
        return self.out_proj(out)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.self_attention = SelfAttention(dim, num_heads)
        self.ln_2 = nn.LayerNorm(dim, eps=_LN_EPS)
        # torchvision's MLPBlock: Linear, GELU, Dropout, Linear, Dropout (the
        # dropouts are the identity in eval mode, the only mode of a victim).
        self.mlp = nn.Sequential(nn.Linear(dim, mlp_dim), nn.GELU(), nn.Identity(),
                                 nn.Linear(mlp_dim, dim), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attention(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Encoder(nn.Module):
    def __init__(self, seq_length: int, num_layers: int, dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.empty(1, seq_length, dim))
        self.layers = nn.Sequential(OrderedDict(
            (f"encoder_layer_{i}", EncoderBlock(dim, num_heads, mlp_dim))
            for i in range(num_layers)))
        self.ln = nn.LayerNorm(dim, eps=_LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.layers(x + self.pos_embedding))


class VisionTransformer(nn.Module):
    """ViT over NCHW input of side ``input_size``; logits out."""

    def __init__(self, input_size: int = 224, patch_size: int = 16, num_layers: int = 12,
                 num_heads: int = 12, hidden_dim: int = 768, mlp_dim: int = 3072,
                 num_classes: int = 1000):
        super().__init__()
        self.conv_proj = nn.Conv2d(3, hidden_dim, patch_size, stride=patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        seq_length = (input_size // patch_size) ** 2 + 1
        self.encoder = Encoder(seq_length, num_layers, hidden_dim, num_heads, mlp_dim)
        self.heads = nn.Sequential(OrderedDict(head=nn.Linear(hidden_dim, num_classes)))
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_proj(x).flatten(2).transpose(1, 2)  # (N, patches, D), row-major
        x = torch.cat([self.class_token.expand(x.shape[0], -1, -1), x], dim=1)
        return self.heads(self.encoder(x)[:, 0])


def vit_b16(num_classes: int = 1000, input_size: int = 224) -> VisionTransformer:
    return VisionTransformer(input_size, num_classes=num_classes)


def vit_tiny(num_classes: int = 1000, input_size: int = 224) -> VisionTransformer:
    """Small ViT for CPU tests."""
    return VisionTransformer(input_size, num_layers=2, num_heads=4, hidden_dim=64, mlp_dim=128,
                             num_classes=num_classes)
