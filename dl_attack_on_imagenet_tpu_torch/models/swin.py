"""Swin Transformer (Swin-B and a tiny one for tests) as torchvision-shaped
modules.

Liu et al. 2021, "Swin Transformer: Hierarchical Vision Transformer using
Shifted Windows" (arXiv:2103.14030), as torchvision's ``swin_b`` computes it
in eval mode: a stride-4 patch convolution and LayerNorm, four stages of
pre-norm blocks over an (N, H, W, C) map, patch merging between them, the
final LayerNorm, the average over the map and the head. A block's attention
runs in windows of ``window`` x ``window`` tokens; every second block of a
stage first rolls the map by ``window // 2`` up and left, masks the scores
of token pairs that the roll brought from different regions with -100, and
rolls back after. Where the window covers the map on an axis the shift on
that axis is 0, as torchvision and the official code set it (Swin-B's
fourth stage). Every stage's map has to be a multiple of the window (Swin-B
at 224²; torchvision pads other maps, which the port refuses). Every score
matrix gets the learned relative-position bias, read from
``relative_position_bias_table`` through a fixed index on every forward.
LayerNorm eps is 1e-5, GELU the exact erf one, and dropout and stochastic
depth are the identity (a victim is always in eval mode).

The qkv Linear runs on the map as it is, before any roll (it is per
token, as the proj Linear is), and the module takes its (N, H, W, 3C)
output and the bias table to the (N, H, W, C) input of proj by device: on
the card through :func:`~..ops.kernels.swin_window_attention`, one
hand-written kernel, forward and input gradient, with the roll, the
partition, the bias, the mask and their reverse in its indexing; on the
CPU through the plain twin :func:`window_attention_reference` (roll,
:func:`_partition`, vit.py's :func:`~.vit.attend` with the bias and mask as
its additive term, :func:`_reverse`, roll back).

The names are torchvision's: ``features.0.{0,2}`` for the stem,
``features.{1,3,5,7}.i.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.0, mlp.3}`` for the blocks,
``features.{2,4,6}.{reduction, norm}`` for the merges, ``norm`` and
``head``; the relative-position index is computed
(:func:`relative_position_index`), not kept in the ``state_dict``.

fp32 only: the port has no bf16 Swin (``dtype=torch.bfloat16`` raises).

Spans (``utils.profiling.annotate``, device-timed on the card): per block
``victim/swin/attention`` (``x + attention(norm1(x))``), with, in the plain
twin only, ``victim/swin/shift`` inside it twice (roll and partition;
reverse and roll back: on the card the kernel's indexing does that work),
and ``victim/swin/mlp`` (``x + mlp(norm2(x))``); per merge
``victim/swin/merge``; ``victim/swin/embed`` (the stem) and
``victim/swin/head`` (the final LayerNorm, pool and head) once a pass.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.kernels import swin_window_attention
from ..utils.profiling import annotate
from .layers import Conv2d, Linear, resolve_dtype
from .vit import GELU, LayerNorm, attend

_LN_EPS = 1e-5
_MASKED = -100.0


def relative_position_index(window: int, device=None) -> torch.Tensor:
    """(window², window²) → row of the bias table: for tokens at (y1, x1)
    and (y2, x2) of a window, (y1 - y2 + window - 1) * (2 window - 1) +
    (x1 - x2 + window - 1), flattened; computed on ``device`` (no copy to
    it, which would wait for the card)."""
    y, x = torch.meshgrid(torch.arange(window, device=device), torch.arange(window, device=device),
                          indexing="ij")
    y, x = y.flatten(), x.flatten()
    dy = y[:, None] - y[None, :] + window - 1
    dx = x[:, None] - x[None, :] + window - 1
    return (dy * (2 * window - 1) + dx).flatten()


def _bands(n: int, window: int, shift: int, device) -> torch.Tensor:
    """The region of each row (or column) of a map rolled by ``shift``:
    0 before the last window, 1 in it up to the rows the roll brought round,
    2 for those; all 0 where there is no shift."""
    i = torch.arange(n, device=device)
    if not shift:
        return torch.zeros_like(i)
    return (i >= n - window).long() + (i >= n - shift).long()


def _partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(N, H, W, C) → (N * windows, window², C), windows in row-major order."""
    n, h, w, c = x.shape
    x = x.view(n, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _reverse(x: torch.Tensor, window: int, n: int, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`_partition`."""
    c = x.shape[-1]
    x = x.view(n, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, c)


def relative_bias(table: torch.Tensor, window: int) -> torch.Tensor:
    """(heads, window², window²), gathered from ``table`` as it is now."""
    n = window * window
    return table[relative_position_index(window, table.device)].view(n, n, -1).permute(2, 0, 1)


def window_mask(h: int, w: int, window: int, sh: int, sw: int, device) -> torch.Tensor:
    """(windows, window², window²): 0 between tokens of one region of the
    map rolled by (-sh, -sw), -100 between tokens of two; each token's
    region from its rolled row and column (:func:`_bands`), as the kernel
    computes it."""
    region = _bands(h, window, sh, device)[:, None] * 3 + _bands(w, window, sw, device)[None, :]
    region = _partition(region[None, :, :, None], window)[..., 0]
    return torch.where(region[:, :, None] == region[:, None, :], 0.0, _MASKED)


def window_attention_reference(qkv: torch.Tensor, table: torch.Tensor, window: int, sh: int,
                               sw: int, heads: int) -> torch.Tensor:
    """The plain twin of :func:`~..ops.kernels.swin_window_attention`: the
    (N, H, W, 3C) qkv map rolled by (-sh, -sw) and cut into windows,
    softmax(q kᵀ / sqrt(head dim) + bias + mask) v in each window and head
    (:func:`~.vit.attend`), the windows put back and the map rolled back;
    (N, H, W, C) out. Its roll and partition, and their reverse, are
    ``victim/swin/shift`` spans."""
    n, h, w, c3 = qkv.shape
    c, tokens = c3 // 3, window * window
    with annotate("victim/swin/shift", device=qkv.is_cuda) as span:
        rolled = torch.roll(qkv, shifts=(-sh, -sw), dims=(1, 2)) if sh or sw else qkv
        windows = span.backward(qkv, _partition(rolled, window))
    q, k, v = windows.view(-1, tokens, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    bias = relative_bias(table, window)[None]
    if sh or sw:
        bias = bias + window_mask(h, w, window, sh, sw, qkv.device)[:, None]
    out = attend(q, k, v, bias).transpose(1, 2).reshape(-1, tokens, c)
    with annotate("victim/swin/shift", device=qkv.is_cuda) as span:
        y = _reverse(out, window, n, h, w)
        if sh or sw:
            y = torch.roll(y, shifts=(sh, sw), dims=(1, 2))
        return span.backward(out, y)


class _Permute(nn.Module):
    """torchvision's ``Permute`` of the stem (NCHW → NHWC)."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.dims = tuple(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(*self.dims)


class ShiftedWindowAttention(nn.Module):
    """Window attention with a relative-position bias, shifted by ``shift``
    (0 for a plain window block), under torchvision's names."""

    def __init__(self, dim: int, window: int, shift: int, num_heads: int):
        super().__init__()
        self.window, self.shift, self.num_heads = window, shift, num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        win = self.window
        if h % win or w % win:
            raise ValueError(f"Swin's {win}x{win} windows do not tile a {h}x{w} map; take an "
                             f"input size whose maps they tile (224 for Swin-B)")
        sh = self.shift if win < h else 0
        sw = self.shift if win < w else 0
        qkv = self.qkv(x)
        attention = swin_window_attention if qkv.is_cuda else window_attention_reference
        return self.proj(attention(qkv, self.relative_position_bias_table, win, sh, sw,
                                   self.num_heads))


class SwinBlock(nn.Module):
    """torchvision's ``SwinTransformerBlock`` in eval mode."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, eps=_LN_EPS)
        self.attn = ShiftedWindowAttention(dim, window, shift, num_heads)
        self.norm2 = LayerNorm(dim, eps=_LN_EPS)
        # torchvision's MLP: Linear, GELU, Dropout, Linear, Dropout.
        self.mlp = nn.Sequential(Linear(dim, hidden), GELU(), nn.Identity(),
                                 Linear(hidden, dim), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("victim/swin/attention", device=x.is_cuda) as span:
            x = span.backward(x, x + self.attn(self.norm1(x)))
        with annotate("victim/swin/mlp", device=x.is_cuda) as span:
            return span.backward(x, x + self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """torchvision's ``PatchMerging``: each 2x2 patch's four tokens
    concatenated ((0, 0), (1, 0), (0, 1), (1, 1)), LayerNorm, and a
    bias-free Linear from 4C to 2C."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(4 * dim, eps=_LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("victim/swin/merge", device=x.is_cuda) as span:
            cat = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                             x[:, 1::2, 1::2]], dim=-1)
            return span.backward(x, self.reduction(self.norm(cat)))


class SwinTransformer(nn.Module):
    """Swin over NCHW input; logits out."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2), num_heads: Sequence[int] = (4, 8, 16, 32),
                 window: int = 7, mlp_ratio: float = 4.0, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if resolve_dtype(dtype) != torch.float32:
            raise ValueError("Swin is built in float32 only; the port has no bf16 Swin")
        layers = [nn.Sequential(Conv2d(3, embed_dim, patch_size, stride=patch_size),
                                _Permute((0, 2, 3, 1)), LayerNorm(embed_dim, eps=_LN_EPS))]
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            dim = embed_dim * 2 ** i
            layers.append(nn.Sequential(*(
                SwinBlock(dim, heads, window, 0 if j % 2 == 0 else window // 2, mlp_ratio)
                for j in range(depth))))
            if i < len(depths) - 1:
                layers.append(PatchMerging(dim))
        self.features = nn.Sequential(*layers)
        dim = embed_dim * 2 ** (len(depths) - 1)
        self.norm = LayerNorm(dim, eps=_LN_EPS)
        self.head = Linear(dim, num_classes)
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("victim/swin/embed", device=x.is_cuda) as span:
            y = span.backward(x, self.features[0](x))
        for layer in self.features[1:]:
            y = layer(y)
        with annotate("victim/swin/head", device=x.is_cuda) as span:
            return span.backward(y, self.head(self.norm(y).mean(dim=(1, 2))))


def swin_b(num_classes: int = 1000, dtype: torch.dtype = torch.float32) -> SwinTransformer:
    """Swin-B: patch 4, embedding 128, depths (2, 2, 18, 2), heads (4, 8,
    16, 32), window 7, MLP ratio 4 (torchvision's ``swin_b``)."""
    return SwinTransformer(num_classes=num_classes, dtype=dtype)


def swin_tiny(num_classes: int = 1000, dtype: torch.dtype = torch.float32) -> SwinTransformer:
    """Small Swin for CPU tests: embedding 16, depths (2, 2, 2), heads (2,
    4, 8), window 4; at 64² it has shifted blocks, two merges and a last
    stage whose window covers the map."""
    return SwinTransformer(embed_dim=16, depths=(2, 2, 2), num_heads=(2, 4, 8), window=4,
                           num_classes=num_classes, dtype=dtype)
