"""XCiT (XCiT-L12/16 and a small one for tests) as timm-shaped modules.

El-Nouby et al. 2021, "XCiT: Cross-Covariance Image Transformers"
(arXiv:2106.09681), as timm's ``xcit_large_12_p16_224`` and the official
``xcit.py`` compute it in eval mode:

- **Stem** (patch 16): four 3x3 stride-2 convolutions without bias, each
  followed by a BatchNorm, 3 -> C/8 -> C/4 -> C/2 -> C, with the exact
  GELU after the first three; the (C, H/16, W/16) map is read as N tokens
  of width C. A Fourier encoding of each token's (row, column) (hidden
  width 32, temperature 10000, scale 2π, coordinates 1..side over side +
  1e-6) goes through a 1x1 convolution 64 -> C with a bias and is added.
- **XCA blocks**, each ``x + γ1 XCA(LN1 x)``, then ``x + γ3 LPI(LN3 x)``,
  then ``x + γ2 MLP(LN2 x)`` (timm's order, 1, 3, 2). XCA attends across
  channels: q, k, v = LN(x) W_qkv + b in heads of d channels; q and k are
  l2-normalized over the N tokens, channel by channel (``F.normalize``,
  eps 1e-12); A = softmax(τ_h q̂ k̂ᵀ) is d x d a head, with a learned
  temperature τ a head; each token's output is A v_n, then the projection.
  On the card XCA's core, from the qkv Linear's output to the proj's
  input, is the port's kernel (``ops.kernels.xcit_xca``), forward and input
  gradient; on the CPU its twin ``xca_reference`` runs timm's operations.
  LPI is a 3x3 depthwise convolution (a bias), GELU, BatchNorm and a second
  3x3 depthwise convolution on the tokens as a map. The MLP is C -> 4C ->
  C with the exact GELU.
- **Class attention** (2 layers), after a class token is put before the
  tokens: u = LN1(x); the class row's output is the projection of
  softmax(q₀ kᵀ / sqrt(d)) v over all rows of u, with q₀ from u's class row
  alone; y = x + γ1 [that; u's patch rows] (the patch rows add their own
  normalized values), then y = LN2(y) on every row (``tokens_norm``), and
  the output is y + [γ2 MLP(y₀); y's patch rows] (the patch rows doubled).
  The second layer's keys and values read those rows.
- **Head:** a LayerNorm and the Linear on the class row. (The LayerNorm of
  the other rows, which timm also computes, reaches no logit.)

LayerNorm eps is 1e-6, BatchNorm eps 1e-5; dropout and stochastic depth
are the identity (a victim is always in eval mode).

Layouts. The token stream is contiguous (B, N, C) rows, on which the
GEMMs run. Every convolution takes its input and weight in contiguous
NCHW (``victim_memory_format``): the stem's from the image, and LPI's
from a copy of its tokens as a (B, C, H, W) map (timm's reshape of the
transposed tokens would hand it channels_last strides); LPI's output goes
back to rows as a transposed view, which the residual add writes into the
stream's contiguous rows.

The names are timm's: ``patch_embed.proj.{0,2,4,6}.{0,1}`` (convolution,
BatchNorm), ``pos_embed.token_projection``, ``blocks.i.{norm1,
attn.{temperature, qkv, proj}, gamma1, norm3, local_mp.{conv1, bn,
conv2}, gamma3, norm2, mlp.{fc1, fc2}, gamma2}``, ``cls_token``,
``cls_attn_blocks.i.{norm1, attn.{q, k, v, proj}, gamma1, norm2,
mlp.{fc1, fc2}, gamma2}``, ``norm``, ``head``; a timm ``state_dict``
loads strictly. fp32 only: the port has no bf16 XCiT
(``dtype=torch.bfloat16`` raises).

Spans (``utils.profiling.annotate``, device-timed on the card):
``victim/xcit/stem`` (the stem and the position encoding), per block
``victim/xcit/xca``, ``victim/xcit/lpi`` and ``victim/xcit/mlp`` (each
x -> x + γ·branch), per class-attention layer ``victim/xcit/class_attn``
(the first with the class token's concatenation), and ``victim/xcit/head``.
Together they tile a pass, forward and input gradient.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kernels
from ..utils.profiling import annotate
from .layers import Conv2d, Linear, resolve_dtype
from .vit import GELU, LayerNorm, attend

_LN_EPS = 1e-6
_ETA = 1e-5  # timm's xcit_*_12_* layer-scale initial value


def _conv3x3_bn(cin: int, cout: int) -> nn.Sequential:
    """timm's ``conv3x3``: a 3x3 stride-2 convolution without bias and a
    BatchNorm."""
    return nn.Sequential(Conv2d(cin, cout, 3, stride=2, padding=1, bias=False),
                         nn.BatchNorm2d(cout))


class ConvPatchEmbed(nn.Module):
    """timm's ``ConvPatchEmbed`` at patch 16: four stride-2 convolutions,
    GELU between them; NCHW in, an NCHW map of side/16 out."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Sequential(_conv3x3_bn(3, dim // 8), GELU(),
                                  _conv3x3_bn(dim // 8, dim // 4), GELU(),
                                  _conv3x3_bn(dim // 4, dim // 2), GELU(),
                                  _conv3x3_bn(dim // 2, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class PositionalEncodingFourier(nn.Module):
    """timm's ``PositionalEncodingFourier``: (1, dim, h, w), which depends
    on the map's size alone; the features are computed in fp32 and cast to
    the projection's dtype, as timm casts them."""

    def __init__(self, dim: int, hidden_dim: int = 32, temperature: float = 10000.0):
        super().__init__()
        self.token_projection = Conv2d(2 * hidden_dim, dim, 1)
        self.hidden_dim, self.temperature = hidden_dim, temperature

    def forward(self, h: int, w: int) -> torch.Tensor:
        dev = self.token_projection.weight.device
        scale, eps = 2 * math.pi, 1e-6
        y = torch.arange(1, h + 1, device=dev, dtype=torch.float32)[:, None].expand(h, w)
        x = torch.arange(1, w + 1, device=dev, dtype=torch.float32)[None, :].expand(h, w)
        y = y / (h + eps) * scale
        x = x / (w + eps) * scale
        dim_t = torch.arange(self.hidden_dim, device=dev, dtype=torch.float32)
        dim_t = self.temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                                     / self.hidden_dim)
        pos_x, pos_y = x[:, :, None] / dim_t, y[:, :, None] / dim_t
        pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()], dim=3).flatten(2)
        pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()], dim=3).flatten(2)
        pos = torch.cat([pos_y, pos_x], dim=2).permute(2, 0, 1)[None]
        return self.token_projection(pos.to(self.token_projection.weight.dtype).contiguous())


def xca_reference(qkv: torch.Tensor, temperature: torch.Tensor, heads: int) -> torch.Tensor:
    """XCA's core between its qkv and proj Linears, in timm's operations:
    the plain twin of :func:`~..ops.kernels.xcit_xca`. ``qkv`` is the
    (B, N, 3C) output of the qkv Linear; returns the (B, N, C) input of the
    projection."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    # (3, B, heads, d, N): each head's channels over the tokens.
    q, k, v = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 4, 1)
    q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
    attn = torch.softmax((q @ k.transpose(-2, -1)) * temperature, dim=-1)
    return (attn @ v).permute(0, 3, 1, 2).reshape(b, n, c)


class XCA(nn.Module):
    """Cross-covariance attention over (B, N, C) rows (timm's ``XCA``): on
    the card its core is the port's kernel, elsewhere the plain twin."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)
        core = kernels.xcit_xca if qkv.is_cuda else xca_reference
        return self.proj(core(qkv, self.temperature, self.num_heads))


class LPI(nn.Module):
    """Local patch interaction (timm's ``LPI``): 3x3 depthwise convolution,
    GELU, BatchNorm, 3x3 depthwise convolution, on the (B, N, C) tokens as
    a contiguous (B, C, h, w) map; a transposed (B, N, C) view out."""

    def __init__(self, dim: int, kernel_size: int = 3):
        super().__init__()
        self.conv1 = Conv2d(dim, dim, kernel_size, padding=kernel_size // 2, groups=dim)
        self.act = GELU()
        self.bn = nn.BatchNorm2d(dim)
        self.conv2 = Conv2d(dim, dim, kernel_size, padding=kernel_size // 2, groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        m = x.transpose(1, 2).reshape(b, c, h, w).contiguous()
        m = self.conv2(self.bn(self.act(self.conv1(m))))
        return m.reshape(b, c, n).transpose(1, 2)


class Mlp(nn.Module):
    """timm's ``Mlp``: Linear, exact GELU, Linear."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1, self.act, self.fc2 = Linear(dim, hidden), GELU(), Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class XCABlock(nn.Module):
    """timm's ``XCABlock`` in eval mode: XCA, LPI and MLP sublayers, each a
    span (see the module)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, eta: float):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=_LN_EPS)
        self.attn = XCA(dim, num_heads)
        self.gamma1 = nn.Parameter(torch.full((dim,), eta))
        self.norm3 = LayerNorm(dim, eps=_LN_EPS)
        self.local_mp = LPI(dim)
        self.gamma3 = nn.Parameter(torch.full((dim,), eta))
        self.norm2 = LayerNorm(dim, eps=_LN_EPS)
        self.mlp = Mlp(dim, mlp_ratio * dim)
        self.gamma2 = nn.Parameter(torch.full((dim,), eta))

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        with annotate("victim/xcit/xca", device=x.is_cuda) as span:
            x = span.backward(x, torch.addcmul(x, self.gamma1, self.attn(self.norm1(x))))
        with annotate("victim/xcit/lpi", device=x.is_cuda) as span:
            x = span.backward(x, torch.addcmul(x, self.gamma3,
                                               self.local_mp(self.norm3(x), h, w)))
        with annotate("victim/xcit/mlp", device=x.is_cuda) as span:
            return span.backward(x, torch.addcmul(x, self.gamma2, self.mlp(self.norm2(x))))


class ClassAttn(nn.Module):
    """timm's ``ClassAttn``: the class row's query against every row's keys
    and values (:func:`~.vit.attend`)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q, self.k, self.v = Linear(dim, dim), Linear(dim, dim), Linear(dim, dim)
        self.proj = Linear(dim, dim)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        b, n, c = u.shape
        d = c // self.num_heads
        q = self.q(u[:, :1]).reshape(b, 1, self.num_heads, d).transpose(1, 2)
        k = self.k(u).reshape(b, n, self.num_heads, d).transpose(1, 2)
        v = self.v(u).reshape(b, n, self.num_heads, d).transpose(1, 2)
        return self.proj(attend(q, k, v).transpose(1, 2).reshape(b, 1, c))


class ClassAttentionBlock(nn.Module):
    """timm's ``ClassAttentionBlock`` with ``tokens_norm=True``, in eval
    mode, both of its quirks kept (see the module)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, eta: float):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=_LN_EPS)
        self.attn = ClassAttn(dim, num_heads)
        self.norm2 = LayerNorm(dim, eps=_LN_EPS)
        self.mlp = Mlp(dim, mlp_ratio * dim)
        self.gamma1 = nn.Parameter(torch.full((dim,), eta))
        self.gamma2 = nn.Parameter(torch.full((dim,), eta))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u = self.norm1(x)
        y = self.norm2(torch.addcmul(x, self.gamma1, torch.cat([self.attn(u), u[:, 1:]], dim=1)))
        cls = torch.addcmul(y[:, :1], self.gamma2, self.mlp(y[:, :1]))
        return torch.cat([cls, y[:, 1:] + y[:, 1:]], dim=1)


class XCiT(nn.Module):
    """XCiT at patch 16 over NCHW input; logits out."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 16,
                 mlp_ratio: int = 4, cls_attn_layers: int = 2, eta: float = _ETA,
                 num_classes: int = 1000, dtype: torch.dtype = torch.float32):
        super().__init__()
        if resolve_dtype(dtype) != torch.float32:
            raise ValueError("XCiT is built in float32 only; the port has no bf16 XCiT")
        self.patch_embed = ConvPatchEmbed(embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = PositionalEncodingFourier(embed_dim)
        self.blocks = nn.ModuleList(XCABlock(embed_dim, num_heads, mlp_ratio, eta)
                                    for _ in range(depth))
        self.cls_attn_blocks = nn.ModuleList(
            ClassAttentionBlock(embed_dim, num_heads, mlp_ratio, eta)
            for _ in range(cls_attn_layers))
        self.norm = LayerNorm(embed_dim, eps=_LN_EPS)
        self.head = Linear(embed_dim, num_classes)
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("victim/xcit/stem", device=x.is_cuda) as span:
            m = self.patch_embed(x)
            _, _, h, w = m.shape
            y = span.backward(x, (m + self.pos_embed(h, w)).flatten(2).transpose(1, 2)
                              .contiguous())
        for block in self.blocks:
            y = block(y, h, w)
        cls = self.cls_token.expand(y.shape[0], -1, -1)
        for i, block in enumerate(self.cls_attn_blocks):
            with annotate("victim/xcit/class_attn", device=x.is_cuda) as span:
                y = span.backward(y, block(torch.cat([cls, y], dim=1) if i == 0 else y))
        with annotate("victim/xcit/head", device=x.is_cuda) as span:
            return span.backward(y, self.head(self.norm(y[:, 0])))


def xcit_l12(num_classes: int = 1000, dtype: torch.dtype = torch.float32) -> XCiT:
    """XCiT-L12/16: embed 768, 12 blocks, 16 heads of 48, MLP ratio 4, 2
    class-attention layers (timm's ``xcit_large_12_p16_224``)."""
    return XCiT(num_classes=num_classes, dtype=dtype)


def xcit_mini(num_classes: int = 1000, dtype: torch.dtype = torch.float32) -> XCiT:
    """Small XCiT for CPU tests: embed 64, 2 blocks, 4 heads of 16, the 2
    class-attention layers; at 64² its token map is 4x4, so LPI's 3x3
    kernels reach past it on every side."""
    return XCiT(embed_dim=64, depth=2, num_heads=4, num_classes=num_classes, dtype=dtype)
