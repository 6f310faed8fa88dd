"""Vision Transformer (ViT-B/16 and a tiny one for tests) as
torchvision-shaped modules.

Port of ``dl_attack_on_imagenet_tpu/models/vit.py``: a stride-16 patch
convolution (the JAX package's reshape + matmul is a TPU layout of the same
map, with the same weights), a class token, learned position embeddings
sized from ``input_size``, pre-norm encoder blocks with LayerNorm eps 1e-6
(flax's, and torchvision's ViT's), exact erf GELU, and the head on the
class token. Attention is written out in fp32, as flax computes it:
softmax(q k^T / sqrt(head_dim)) v (:func:`attend`, which Swin shares), with
q, k and v packed in ``in_proj_weight``. The names are torchvision's
(``conv_proj``, ``class_token``, ``encoder.pos_embedding``,
``encoder.layers.encoder_layer_i.{ln_1, self_attention, ln_2, mlp.0,
mlp.3}``, ``encoder.ln``, ``heads.head``).

``dtype=torch.bfloat16`` follows Flax's ``dtype=`` op by op, each result
rounded to bf16 as XLA rounds it: the patch projection, q, k, v, the
scores, the attention-weighted values and every dense layer are bf16
products with an fp32 accumulator and their bias added after them in bf16;
the softmax runs in bf16 (Flax's default, ``force_fp32_for_softmax=False``:
the shift, the exponent and the quotient each rounded, the sum in fp32);
the exact GELU is ``0.5 * x * erfc(-x * sqrt(0.5))`` in bf16, as
``jax.nn.gelu`` writes it; LayerNorm reduces in fp32 with Flax's
``E[x^2] - E[x]^2`` variance and rounds its result; the class token and the
position embedding are cast to bf16.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Linear, set_compute_dtype

_LN_EPS = 1e-6


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A constant rounded to ``like``'s dtype, as JAX rounds a constant."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


class _SoftmaxLowp(torch.autograd.Function):
    """``jax.nn.softmax`` of a bf16 tensor over its last axis: ``u =
    exp(s - max)`` and ``u / w`` with ``w`` the fp32 sum of ``u`` rounded,
    op by op, and the backward JAX's autodiff makes of it (the max held
    constant): ``(g / w - sum(g * (1 / (w * w)) * u)) * u``, the sum in
    fp32 rounded once."""

    @staticmethod
    def forward(ctx, s: torch.Tensor) -> torch.Tensor:
        u = torch.exp(s - s.amax(-1, keepdim=True))
        w = u.float().sum(-1, keepdim=True).to(s.dtype)
        ctx.save_for_backward(u, w)
        return u / w

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        u, w = ctx.saved_tensors
        s = ((g * (1 / (w * w))) * u).float().sum(-1, keepdim=True).to(g.dtype)
        return (g / w - s) * u


class _GeluLowp(torch.autograd.Function):
    """``jax.nn.gelu(approximate=False)`` of a bf16 tensor, op by op:
    ``0.5 * x * erfc(-x * c)`` with ``c`` = sqrt(0.5) rounded to bf16, and
    the backward JAX's autodiff makes of it (``erfc``'s derivative with
    -2/sqrt(pi) rounded to bf16)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        z = -x * _const(math.sqrt(0.5), x)
        e = torch.erfc(z)
        ctx.save_for_backward(x, z, e)
        return 0.5 * x * e

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        x, z, e = ctx.saved_tensors
        z_bar = (_const(-2.0 / math.sqrt(math.pi), g) * (0.5 * x * g)) * torch.exp(-(z * z))
        return 0.5 * (g * e) - z_bar * _const(math.sqrt(0.5), g)


class GELU(nn.Module):
    """Exact (erf) GELU: ``F.gelu`` in fp32, :class:`_GeluLowp` in a lower
    precision."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in (torch.float32, torch.float64):
            return F.gelu(x)
        return _GeluLowp.apply(x)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` in fp32; on a lower precision, Flax's: statistics
    in fp32 with ``var = E[x^2] - E[x]^2`` (clipped at 0), the fp32 affine,
    and one rounding back to the input's dtype. The input is cast twice, as
    Flax casts it for the statistics and for the normalization, so that
    the two gradients meet in the input's dtype there too."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in (torch.float32, torch.float64):
            return super().forward(x)
        xs = x.float()
        mean = xs.mean(-1, keepdim=True)
        var = torch.clamp_min((xs * xs).mean(-1, keepdim=True) - mean * mean, 0.0)
        y = (x.float() - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(head_dim) + bias) v over the last two axes, in
    the inputs' dtype: ViT's fp32 attention, and Swin's, whose ``bias``
    (the relative-position bias, with the shifted windows' mask) is
    broadcast over the leading axes of the scores (``bias.shape`` has to
    divide them: (windows, heads, n, n) or (1, heads, n, n))."""
    scores = (q / math.sqrt(q.shape[-1])) @ k.transpose(-2, -1)
    if bias is not None:
        scores = (scores.view(-1, *bias.shape) + bias).view(scores.shape)
    return torch.softmax(scores, dim=-1) @ v


class SelfAttention(nn.Module):
    """Multi-head self-attention under ``nn.MultiheadAttention``'s parameter
    names, computed without a fused kernel, in ``compute_dtype`` where set
    (see the module's docstring)."""

    compute_dtype = None

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, length, dim = x.shape
        head_dim = dim // self.num_heads
        dt = self.compute_dtype
        if dt is None:
            qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
            q, k, v = qkv.view(n, length, 3, self.num_heads, head_dim).permute(2, 0, 3, 1, 4)
            out = attend(q, k, v)
        else:
            # Flax projects q, k and v by three dense layers, so x's
            # gradient is three bf16 products summed in bf16.
            x = x.to(dt)
            q, k, v = (
                (F.linear(x, w.to(dt)) + b.to(dt)).view(n, length, self.num_heads, head_dim)
                .transpose(1, 2)
                for w, b in zip(self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)))
            scores = (q / _const(math.sqrt(head_dim), q)) @ k.transpose(-2, -1)
            out = _SoftmaxLowp.apply(scores) @ v
        out = out.transpose(1, 2).reshape(n, length, dim)
        return self.out_proj(out)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.ln_1 = LayerNorm(dim, eps=_LN_EPS)
        self.self_attention = SelfAttention(dim, num_heads)
        self.ln_2 = LayerNorm(dim, eps=_LN_EPS)
        # torchvision's MLPBlock: Linear, GELU, Dropout, Linear, Dropout (the
        # dropouts are the identity in eval mode, the only mode of a victim).
        self.mlp = nn.Sequential(Linear(dim, mlp_dim), GELU(), nn.Identity(),
                                 Linear(mlp_dim, dim), nn.Identity())

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
        self.ln = LayerNorm(dim, eps=_LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.layers(x + self.pos_embedding.to(x.dtype)))


class VisionTransformer(nn.Module):
    """ViT over NCHW input of side ``input_size``; logits out."""

    def __init__(self, input_size: int = 224, patch_size: int = 16, num_layers: int = 12,
                 num_heads: int = 12, hidden_dim: int = 768, mlp_dim: int = 3072,
                 num_classes: int = 1000, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_proj = Conv2d(3, hidden_dim, patch_size, stride=patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        seq_length = (input_size // patch_size) ** 2 + 1
        self.encoder = Encoder(seq_length, num_layers, hidden_dim, num_heads, mlp_dim)
        self.heads = nn.Sequential(OrderedDict(head=Linear(hidden_dim, num_classes)))
        self.num_classes = num_classes
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_proj(x).flatten(2).transpose(1, 2)  # (N, patches, D), row-major
        x = torch.cat([self.class_token.to(x.dtype).expand(x.shape[0], -1, -1), x], dim=1)
        return self.heads(self.encoder(x)[:, 0])


def vit_b16(num_classes: int = 1000, input_size: int = 224,
            dtype: torch.dtype = torch.float32) -> VisionTransformer:
    return VisionTransformer(input_size, num_classes=num_classes, dtype=dtype)


def vit_tiny(num_classes: int = 1000, input_size: int = 224,
             dtype: torch.dtype = torch.float32) -> VisionTransformer:
    """Small ViT for CPU tests."""
    return VisionTransformer(input_size, num_layers=2, num_heads=4, hidden_dim=64, mlp_dim=128,
                             num_classes=num_classes, dtype=dtype)
