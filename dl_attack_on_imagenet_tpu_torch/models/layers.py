"""Shared victim building blocks.

Attacks work in [0, 1] pixel space; the ImageNet mean/std shift lives inside
the victim so that gradients flow through it. Port of
``dl_attack_on_imagenet_tpu/models/layers.py``, over NCHW views: the
normalization and torchvision's ``transform_input`` affine (both tiled over
the channels of a space-to-depth input), the space-to-depth layout of the
S2D stems, the conv -> BN -> ReLU block, and the pools with the JAX
package's padding rules.

**Compute dtype.** :class:`Conv2d` and :class:`Linear` keep fp32 parameters
and, given a ``compute_dtype`` (:func:`set_compute_dtype`, the Flax layers'
``dtype=``), cast their input and their weights to it: a bf16 convolution
accumulates in fp32 and rounds once, and its bias is added after it in
bf16, as Flax adds it. BatchNorm takes the bf16 activation and computes in
fp32 (torch's mixed-dtype ``batch_norm``, Flax's ``x - mean`` promotion),
returning bf16. The average pools of a bf16 tensor sum their taps in bf16,
one rounding a tap in row-major order, as XLA's ``reduce_window`` does on
the CPU; the global average pool sums in fp32 (``jnp.mean``).

**Backward variants.** The JAX package picks the backward pass of every
max pool and every ReLU of the zoo by environment at import:
``ADIL_MAXPOOL`` is ``sas`` (default: the library's first-match backward),
``vjp`` (a first-match backward over the window taps) or ``slices`` (a max
over the taps, whose gradient is split among exact ties);
``ADIL_RELU`` is ``plain`` (default), ``bool`` (the backward keeps a 1-byte
mask) or ``packed`` (the mask packed 8 to a ``uint8`` along the channels,
the innermost memory axis of a channels_last tensor). Only ``slices``
changes a gradient, on ties. :data:`POOL_MODE` and :data:`RELU_MODE` hold
the choice and are read at each call.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Pair = Union[int, Tuple[int, int]]
Padding = Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]
Pads = Tuple[Tuple[int, int], Tuple[int, int]]

POOL_MODE = os.environ.get(
    "ADIL_MAXPOOL", "vjp" if os.environ.get("ADIL_MAXPOOL_VJP", "0") == "1" else "sas")
RELU_MODE = os.environ.get("ADIL_RELU", "plain")


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _channel_buffer(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32).reshape(1, -1, 1, 1)


def _tiled(buf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (1, 3, 1, 1) channel buffer tiled over ``x``'s channels: a
    space-to-depth input has 12, in the order (ki, kj, c) with c fastest."""
    reps = x.shape[1] // buf.shape[1]
    return buf if reps == 1 else buf.repeat(1, reps, 1, 1)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC -> blocked NHWC: (N, H, W, C) -> (N, H/b, W/b, b*b*C), channel
    order (ki, kj, c) with c fastest: the S2D stems' compute layout, and
    the JAX package's ``space_to_depth``. The result is contiguous."""
    n, h, w, c = x.shape
    xb = x.reshape(n, h // block, block, w // block, block, c)
    return xb.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block, block * block * c)


def depth_to_space(xb: torch.Tensor, block: int = 2) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    n, hb, wb, cb = xb.shape
    c = cb // (block * block)
    x = xb.reshape(n, hb, wb, block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, hb * block, wb * block, c)


def space_to_depth_nchw(x: torch.Tensor) -> torch.Tensor:
    """:func:`space_to_depth` of an NCHW view (channels_last in memory, as
    the victims' inputs are), as an NCHW view of the blocked tensor."""
    return space_to_depth(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Normalize(nn.Module):
    """Channel normalization ``(x - mean) / std`` of NCHW images, in the
    input's dtype (mean and std are cast to it), as the JAX wrapper
    normalizes a bf16 input in bf16; tiled over a space-to-depth input's
    channels."""

    def __init__(self, mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD):
        super().__init__()
        self.register_buffer("mean", _channel_buffer(mean), persistent=False)
        self.register_buffer("std", _channel_buffer(std), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - _tiled(self.mean, x).to(x.dtype)) / _tiled(self.std, x).to(x.dtype)


class TransformInput(nn.Module):
    """torchvision's ``transform_input=True`` channel affine,
    ``x_c * (std_c / 0.5) + (mean_c - 0.5) / 0.5`` (the JAX package's
    ``torch_transform_input``). GoogLeNet and Inception-v3 apply it inside
    their forward, on top of the victim's ``Normalize``; tiled over a
    space-to-depth input's channels."""

    def __init__(self):
        super().__init__()
        self.register_buffer("scale", _channel_buffer(IMAGENET_STD) / 0.5, persistent=False)
        self.register_buffer("shift", (_channel_buffer(IMAGENET_MEAN) - 0.5) / 0.5,
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * _tiled(self.scale, x) + _tiled(self.shift, x)


_FULL = (torch.float32, torch.float64)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in a compute dtype: with ``compute_dtype`` set (bf16),
    the input and the fp32 weight are cast to it and the bias is added
    after the convolution in that dtype; without, torch's own forward."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt).reshape(-1, 1, 1)


class Linear(nn.Linear):
    """``nn.Linear`` in a compute dtype, as :class:`Conv2d`."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def set_compute_dtype(net: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make every layer of ``net`` that has a ``compute_dtype`` compute in
    ``dtype`` (None, torch's own forward, for float32); the parameters stay
    as they are. Returns ``net``."""
    dtype = resolve_dtype(dtype)
    for mod in net.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = None if dtype == torch.float32 else dtype
    return net


def resolve_dtype(dtype: torch.dtype) -> torch.dtype:
    """``dtype``, which must be ``torch.float32`` or ``torch.bfloat16``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, not {dtype}")
    return dtype


class _MaskReLU(torch.autograd.Function):
    """ReLU whose backward keeps only ``x > 0``: a bool mask, or the mask
    packed 8 to a byte along the channels (``ADIL_RELU`` "bool" and
    "packed"); the gradient equals the plain ReLU's bit for bit."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, packed: bool) -> torch.Tensor:
        keep = x > 0
        ctx.packed = packed
        if packed:
            ctx.channels = x.shape[_channel_axis(x)]
            keep = pack_bits(keep.movedim(_channel_axis(x), -1))
        ctx.save_for_backward(keep)
        return F.relu(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (keep,) = ctx.saved_tensors
        if ctx.packed:
            keep = unpack_bits(keep, ctx.channels).movedim(-1, _channel_axis(g))
        return torch.where(keep, g, torch.zeros((), dtype=g.dtype, device=g.device)), None


def _channel_axis(x: torch.Tensor) -> int:
    """The channel axis: 1 of an NCHW activation (the innermost memory axis
    in channels_last), the last of a (N, features) one."""
    return 1 if x.dim() == 4 else x.dim() - 1


_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def pack_bits(b: torch.Tensor) -> torch.Tensor:
    """bool (..., C) -> uint8 (..., ceil(C/8)), bit i of byte k = element
    8k+i: the JAX package's ``_pack_bits``."""
    pad = (-b.shape[-1]) % 8
    if pad:
        b = F.pad(b, (0, pad))
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=b.device)
    return (b.reshape(*b.shape[:-1], -1, 8).to(torch.uint8) * w).sum(-1, dtype=torch.uint8)


def unpack_bits(m: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`, cropped back to ``c`` channels."""
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=m.device)
    return ((m[..., None] & w) != 0).reshape(*m.shape[:-1], -1)[..., :c]


def relu(x: torch.Tensor) -> torch.Tensor:
    """The zoo's ReLU, with the backward :data:`RELU_MODE` names."""
    if RELU_MODE == "packed":
        return _MaskReLU.apply(x, True)
    if RELU_MODE == "bool":
        return _MaskReLU.apply(x, False)
    return F.relu(x)


class ReLU(nn.Module):
    """:func:`relu` as a module (no parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu(x)


class BasicConv2d(nn.Module):
    """Conv (no bias) -> frozen BatchNorm -> ReLU, the JAX package's
    ``ConvBN`` under torchvision's ``BasicConv2d`` names (``conv``, ``bn``),
    with the BatchNorm's own ``eps``.

    ``padding=None`` is the JAX package's "TORCH" rule, symmetric ``k // 2``
    on each side of each dimension, so a (1, 7) kernel pads (0, 3); pass 0
    for "VALID". The conv is registered before its BatchNorm, the order
    ``models.fold`` pairs them in. (MobileNetV2's grouped conv -> BN ->
    ReLU6 block is ``mobilenet.ConvBNReLU6``, under torchvision's names
    for it.)
    """

    def __init__(self, cin: int, cout: int, kernel: Pair, stride: Pair = 1,
                 padding: Pair = None, eps: float = 1e-5):
        super().__init__()
        kh, kw = _pair(kernel)
        if padding is None:
            padding = (kh // 2, kw // 2)
        self.conv = Conv2d(cin, cout, (kh, kw), stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu(self.bn(self.conv(x)))


def pool_pads(h: int, w: int, window: Pair, strides: Pair,
              padding: Padding) -> Pads:
    """((top, bottom), (left, right)) padding of a pool, the JAX package's
    ``_pool_pads``: none for "VALID"; for "SAME", XLA's rule, which puts the
    odd pixel at the bottom and right; explicit pads as given."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        out = []
        for size, k, s in zip((h, w), _pair(window), _pair(strides)):
            n_out = -(-size // s)
            total = max((n_out - 1) * s + k - size, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    return tuple(tuple(p) for p in padding)


def _tap_slices(shape: Sequence[int], window: Tuple[int, int], strides: Tuple[int, int],
                pads: Pads) -> List[Tuple[slice, slice]]:
    """The (rows, columns) slices of the padded input that window tap (i, j)
    reads for every output, in row-major tap order."""
    (top, bottom), (left, right) = pads
    ho = (shape[2] + top + bottom - window[0]) // strides[0] + 1
    wo = (shape[3] + left + right - window[1]) // strides[1] + 1
    return [(slice(i, i + strides[0] * (ho - 1) + 1, strides[0]),
             slice(j, j + strides[1] * (wo - 1) + 1, strides[1]))
            for i in range(window[0]) for j in range(window[1])]


def _padded(x: torch.Tensor, pads: Pads, value: float) -> torch.Tensor:
    (top, bottom), (left, right) = pads
    return F.pad(x, (left, right, top, bottom), value=value)


def _max_pool_native(x: torch.Tensor, window: Tuple[int, int], strides: Tuple[int, int],
                     pads: Pads) -> torch.Tensor:
    (top, bottom), (left, right) = pads
    if top == bottom <= window[0] // 2 and left == right <= window[1] // 2:
        return F.max_pool2d(x, window, strides, padding=(top, left))
    return F.max_pool2d(_padded(x, pads, float("-inf")), window, strides)


class _MaxPoolFirstMatch(torch.autograd.Function):
    """Max pool whose backward gives each output's gradient to the first
    tap, in row-major order, that equals the window's maximum: the JAX
    package's ``_max_pool_custom`` (``ADIL_MAXPOOL=vjp``), written over the
    taps, with the contributions added in tap order."""

    @staticmethod
    def forward(ctx, x, window, strides, pads):
        y = _max_pool_native(x, window, strides, pads)
        ctx.save_for_backward(x, y)
        ctx.geometry = (window, strides, pads)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        window, strides, pads = ctx.geometry
        xp = _padded(x, pads, float("-inf"))
        grad = torch.zeros_like(xp)
        taken = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        for rows, cols in _tap_slices(x.shape, window, strides, pads):
            hit = (xp[:, :, rows, cols] == y) & ~taken
            taken |= hit
            grad[:, :, rows, cols] += torch.where(hit, g, zero)
        (top, _), (left, _) = pads
        return grad[:, :, top:top + x.shape[2], left:left + x.shape[3]], None, None, None


def _max_pool_slices(x: torch.Tensor, window: Tuple[int, int], strides: Tuple[int, int],
                     pads: Pads) -> torch.Tensor:
    """Max pool as ``torch.maximum`` folded over the window taps in
    row-major order (``ADIL_MAXPOOL=slices``): the same values, and autograd
    splits a gradient in halves at each exact tie, as ``jax.lax.max``
    does."""
    xp = _padded(x, pads, float("-inf"))
    taps = [xp[:, :, rows, cols] for rows, cols in _tap_slices(x.shape, window, strides, pads)]
    return functools.reduce(torch.maximum, taps)


def max_pool(x: torch.Tensor, window: Pair, strides: Pair, padding: Padding = "SAME") -> torch.Tensor:
    """Max pool of an NCHW tensor with the JAX package's padding (padded
    pixels are -inf) and the backward :data:`POOL_MODE` names. Symmetric
    pads go to ``F.max_pool2d`` as they are; "SAME"'s asymmetric ones (a
    3x3/s2 pool at 112 pads (0, 1)) are padded first. At 224 this is
    torchvision's ``ceil_mode=True``, not at every size: the port follows
    the JAX package."""
    window, strides = _pair(window), _pair(strides)
    pads = pool_pads(x.shape[2], x.shape[3], window, strides, padding)
    if POOL_MODE == "vjp":
        return _MaxPoolFirstMatch.apply(x, window, strides, pads)
    if POOL_MODE == "slices":
        return _max_pool_slices(x, window, strides, pads)
    return _max_pool_native(x, window, strides, pads)


class MaxPool(nn.Module):
    """:func:`max_pool` as a module (no parameters)."""

    def __init__(self, window: Pair, strides: Pair, padding: Padding = "SAME"):
        super().__init__()
        self.window, self.strides, self.padding = window, strides, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(x, self.window, self.strides, self.padding)


def avg_pool(x: torch.Tensor, window: Pair, strides: Pair,
             padding: Padding = "VALID") -> torch.Tensor:
    """Flax's ``avg_pool`` of an NCHW tensor: the sum over the window (zero
    padding counted) divided by its size. In fp32 ``F.avg_pool2d``; in a
    lower precision the taps are added one at a time in row-major order,
    each sum rounded to that precision, as XLA sums a bf16 window on the
    CPU (Flax's ``reduce_window`` keeps the input's dtype)."""
    window, strides = _pair(window), _pair(strides)
    pads = pool_pads(x.shape[2], x.shape[3], window, strides, padding)
    if x.dtype in _FULL:
        (top, bottom), (left, right) = pads
        if top == bottom and left == right:
            return F.avg_pool2d(x, window, strides, padding=(top, left), count_include_pad=True)
        return F.avg_pool2d(_padded(x, pads, 0.0), window, strides)
    xp = _padded(x, pads, 0.0)
    taps = [xp[:, :, rows, cols] for rows, cols in _tap_slices(x.shape, window, strides, pads)]
    return functools.reduce(torch.add, taps) / (window[0] * window[1])


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial axes of an NCHW tensor; a lower precision is
    summed and divided in fp32 and rounded once (``jnp.mean``)."""
    if x.dtype in _FULL:
        return x.mean(dim=(2, 3))
    return x.float().mean(dim=(2, 3)).to(x.dtype)
