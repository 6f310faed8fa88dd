"""The repository's plain Swin Transformer, for the CPU tests: the port's
``models.swin`` is held to it, and the benchmark's copy
(``h100bench/reference/swin.py``, with its ``param_specs``) to it too.
Plain torch in fp32; it imports nothing of the port and no JAX.

Liu et al. 2021 (arXiv:2103.14030), torchvision's ``swin_b`` layout and
parameter names, frozen. The input is NHWC in [0, 1], normalized by the
ImageNet mean and std; a stride-``patch_size`` convolution and LayerNorm
embed it; four stages of pre-norm blocks follow, with patch merging between
them (each 2x2 patch's tokens concatenated in the order (0, 0), (1, 0),
(0, 1), (1, 1), LayerNorm, a bias-free Linear from 4C to 2C); then
LayerNorm, the mean over the map and the head. A block is x + W-MSA(LN(x)),
then x + MLP(LN(x)) with the exact erf GELU; LayerNorm eps is 1e-5. W-MSA:
the map is cut into windows of ``window_size``² tokens, each head's scores
are q kᵀ / sqrt(head_dim) plus the relative-position bias B[i, j] =
table[(yi - yj + w - 1)(2w - 1) + xi - xj + w - 1], softmax, times v, and
the projection. Every second block of a stage rolls the map by w // 2 up
and left first and back after, and adds -100 to the scores of token pairs
from different regions of the rolled map.

Departures from the paper, all as the official code and torchvision run
it: the mask value -100 (the paper says only that the pairs are masked);
the shift is 0 where the window covers the map; no absolute position
embedding; eval mode, so no dropout or stochastic depth. Every map here is
a multiple of the window. ``model(..., without=...)`` leaves out
``"shift"`` (the roll and its mask), ``"mask"`` or ``"bias"`` (the
relative-position bias), for the tests' guard: each is a wrong Swin.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-5


def _widths(cfg):
    """(stage, dim, heads, depth) of each stage."""
    return [(i, cfg["embed_dim"] * 2 ** i, h, d)
            for i, (d, h) in enumerate(zip(cfg["depths"], cfg["num_heads"]))]


def windows(x, w):
    """(n, H, W, C) → (n, H/w, W/w, w², C)."""
    n, h, wd, c = x.shape
    x = x.reshape(n, h // w, w, wd // w, w, c).transpose(2, 3)
    return x.reshape(n, h // w, wd // w, w * w, c)


def unwindows(x, w):
    """The inverse of :func:`windows`."""
    n, nh, nw, _, c = x.shape
    return x.reshape(n, nh, nw, w, w, c).transpose(2, 3).reshape(n, nh * w, nw * w, c)


def relative_bias(table, w):
    """(heads, w², w²): the table's row for each pair's offset."""
    ys, xs = torch.div(torch.arange(w * w), w, rounding_mode="floor"), torch.arange(w * w) % w
    idx = (ys[:, None] - ys[None, :] + w - 1) * (2 * w - 1) + (xs[:, None] - xs[None, :] + w - 1)
    return table[idx.to(table.device)].permute(2, 0, 1)


def shift_mask(h, wd, w, s, device):
    """(H/w, W/w, w², w²): -100 between tokens from different regions of the
    map rolled by ``s``, 0 between tokens of one; regions by the slices
    [0, -w), [-w, -s), [-s, end) of each axis."""
    region = torch.zeros((h, wd), device=device)
    label = 0
    for rows in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for cols in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            region[rows, cols] = label
            label += 1
    r = windows(region[None, :, :, None], w)[0, ..., 0]
    return (r[..., :, None] != r[..., None, :]).float() * -100.0


def attention(params, x, name, heads, shift, w, without=()):
    """One block's (shifted-)window attention on its normed (n, H, W, C)
    map: roll by ``shift``, windows, qkv, the scores with the bias and the
    mask, softmax, the values, proj, back to the map and roll back."""
    n, h, wd, c = x.shape
    hd = c // heads
    roll = shift if "shift" not in without else 0
    if roll:
        x = torch.roll(x, (-roll, -roll), (1, 2))
    t = windows(x, w)  # (n, nh, nw, w², c)
    nh, nw = t.shape[1:3]
    qkv = F.linear(t, params[f"{name}.qkv.weight"], params[f"{name}.qkv.bias"])
    q, k, v = qkv.reshape(n, nh, nw, w * w, 3, heads, hd).permute(4, 0, 1, 2, 5, 3, 6)
    s = q @ k.transpose(-2, -1) / math.sqrt(hd)  # each (n, nh, nw, heads, w², w²)
    if "bias" not in without:
        s = s + relative_bias(params[f"{name}.relative_position_bias_table"], w)
    if roll and "mask" not in without:
        s = s + shift_mask(h, wd, w, shift, x.device)[:, :, None]
    o = (torch.softmax(s, dim=-1) @ v).transpose(-3, -2).reshape(n, nh, nw, w * w, c)
    o = unwindows(F.linear(o, params[f"{name}.proj.weight"], params[f"{name}.proj.bias"]), w)
    return torch.roll(o, (roll, roll), (1, 2)) if roll else o


def model(params, cfg, without=()):
    """The frozen classifier: NHWC [0, 1] images -> logits; ``without``
    names the parts left out (see the module)."""
    dev = params["features.0.0.weight"].device
    mean = torch.tensor(MEAN, device=dev).reshape(1, 3, 1, 1)
    std = torch.tensor(STD, device=dev).reshape(1, 3, 1, 1)
    w = cfg["window_size"]

    def ln(x, name):
        return F.layer_norm(x, (x.shape[-1],), params[f"{name}.weight"], params[f"{name}.bias"],
                            LN_EPS)

    def dense(x, name):
        return F.linear(x, params[f"{name}.weight"], params.get(f"{name}.bias"))

    def forward(images):
        x = (images.permute(0, 3, 1, 2).contiguous() - mean) / std
        p = cfg["patch_size"]
        x = F.conv2d(x, params["features.0.0.weight"], params["features.0.0.bias"], stride=p)
        x = ln(x.permute(0, 2, 3, 1), "features.0.2")
        stages = _widths(cfg)
        for i, d, heads, depth in stages:
            for j in range(depth):
                b = f"features.{2 * i + 1}.{j}"
                shift = w // 2 if j % 2 and w < x.shape[1] else 0
                x = x + attention(params, ln(x, f"{b}.norm1"), f"{b}.attn", heads, shift, w,
                                  without)
                x = x + dense(F.gelu(dense(ln(x, f"{b}.norm2"), f"{b}.mlp.0")), f"{b}.mlp.3")
            if i < len(stages) - 1:
                m = f"features.{2 * i + 2}"
                x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                               x[:, 1::2, 1::2]], dim=-1)
                x = dense(ln(x, f"{m}.norm"), f"{m}.reduction")
        return dense(ln(x, "norm").mean(dim=(1, 2)), "head")

    return forward
