"""The repository's plain XCiT, for the CPU tests: the port's
``models.xcit`` is held to it, and the benchmark's copy
(``h100bench/reference/xcit.py``, with its ``param_specs``) to it too.
Plain torch in fp32; it imports nothing of the port and no JAX.

El-Nouby et al. 2021 (arXiv:2106.09681) at patch 16, timm's ``xcit.py``
layout and parameter names, frozen. The input is NHWC in [0, 1],
normalized by the ImageNet mean and std. The stem is four 3x3 stride-2
convolutions without bias (3 -> C/8 -> C/4 -> C/2 -> C), each followed by
a BatchNorm and the first three by the exact GELU; the tokens of the map
get a Fourier encoding of their (row, column) through a 1x1 convolution.
A block is x + γ1 XCA(LN1 x), x + γ3 LPI(LN3 x), x + γ2 MLP(LN2 x): XCA
is softmax(τ q̂ k̂ᵀ) over channels, q and k l2-normalized over the tokens;
LPI is a 3x3 depthwise convolution, GELU, BatchNorm and a 3x3 depthwise
convolution on the tokens as a map. Each class-attention layer takes u =
LN1(x), the class row's attention a₀ over every row of u, y = LN2(x + γ1
[a₀; u's patch rows]) on every row and returns y + [γ2 MLP(y₀); y's patch
rows]. The head is a LayerNorm and the Linear on the class row.

Departures from the official code, none in arithmetic: timm's three
Linears q, k, v in the class attention where the official code packs
them; the final LayerNorm on the class row alone, the only row the head
reads; eval mode. ``model(..., without=...)`` leaves out
``"patch_rows_add"`` (a class-attention layer adds nothing to the patch
rows: y = LN2(x + γ1 [a₀; 0])), ``"patch_rows_doubled"`` (it returns y +
[γ2 MLP(y₀); 0]) or ``"lpi_order"`` (LPI's BatchNorm before its GELU), for
the tests' guard: each is a wrong XCiT.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
STEM = (0, 2, 4, 6)


def fourier(side: int, hidden: int, temperature: float, device) -> torch.Tensor:
    """(1, 2·hidden, side, side): y's then x's sines and cosines of the
    coordinates 1..side over side + 1e-6, times 2π, over
    temperature^(2⌊i/2⌋/hidden)."""
    t = torch.arange(1, side + 1, dtype=torch.float32, device=device)
    t = t / (side + 1e-6) * (2 * math.pi)
    i = torch.arange(hidden, dtype=torch.float32, device=device)
    a = t[:, None] / temperature ** (2 * torch.div(i, 2, rounding_mode="floor") / hidden)
    enc = torch.stack([a[:, 0::2].sin(), a[:, 1::2].cos()], dim=2).flatten(1)
    grid = [enc[:, None, :].expand(side, side, hidden), enc[None, :, :].expand(side, side, hidden)]
    return torch.cat(grid, dim=2).permute(2, 0, 1)[None].contiguous()


def model(params, cfg, without=()):
    """The frozen classifier: NHWC [0, 1] images -> logits; ``without``
    names the parts left out (see the module)."""
    p = params
    dt, dev = p["head.weight"].dtype, p["head.weight"].device
    mean = torch.tensor(MEAN, device=dev).reshape(1, 3, 1, 1)
    std = torch.tensor(STD, device=dev).reshape(1, 3, 1, 1)
    c, heads = cfg["embed_dim"], cfg["num_heads"]
    d, k = c // heads, cfg["lpi_kernel_size"]
    side = cfg["input_size"] // cfg["patch_size"]
    n_tok = side * side

    def ln(x, name):
        return F.layer_norm(x, (c,), p[f"{name}.weight"], p[f"{name}.bias"], cfg["layer_norm_eps"])

    def bn(x, name):
        return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                            p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0,
                            cfg["batch_norm_eps"])

    def dense(x, name):
        return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])

    def mlp(x, name):
        return dense(F.gelu(dense(x, f"{name}.fc1")), f"{name}.fc2")

    def dwconv(m, name):
        return F.conv2d(m, p[f"{name}.weight"], p[f"{name}.bias"], padding=k // 2, groups=c)

    def xca(u, name):
        n = u.shape[0]
        qkv = dense(u, f"{name}.qkv").reshape(n, n_tok, 3, heads, d).permute(2, 0, 3, 4, 1)
        q, kk, v = F.normalize(qkv[0], dim=-1), F.normalize(qkv[1], dim=-1), qkv[2]
        a = torch.softmax((q @ kk.transpose(-2, -1)) * p[f"{name}.temperature"], dim=-1)
        return dense((a @ v).permute(0, 3, 1, 2).reshape(n, n_tok, c), f"{name}.proj")

    def lpi(u, name):
        n = u.shape[0]
        m = dwconv(u.transpose(1, 2).reshape(n, c, side, side).contiguous(), f"{name}.conv1")
        if "lpi_order" in without:
            m = F.gelu(bn(m, f"{name}.bn"))
        else:
            m = bn(F.gelu(m), f"{name}.bn")
        return dwconv(m, f"{name}.conv2").reshape(n, c, n_tok).transpose(1, 2)

    def class_attn(u, name):
        n, rows, _ = u.shape
        q = dense(u[:, 0], f"{name}.q").reshape(n, heads, 1, d) * d ** -0.5
        kk = dense(u, f"{name}.k").reshape(n, rows, heads, d).transpose(1, 2)
        v = dense(u, f"{name}.v").reshape(n, rows, heads, d).transpose(1, 2)
        return dense((torch.softmax(q @ kk.transpose(-2, -1), dim=-1) @ v).reshape(n, 1, c),
                     f"{name}.proj")

    pos = F.conv2d(fourier(side, cfg["pos_hidden_dim"], cfg["pos_temperature"], dev).to(dt),
                   p["pos_embed.token_projection.weight"], p["pos_embed.token_projection.bias"])
    pos = pos.flatten(2).transpose(1, 2)  # (1, N, C)

    def forward(images):
        x = (images.permute(0, 3, 1, 2).contiguous() - mean) / std
        for i, j in enumerate(STEM):
            x = bn(F.conv2d(x, p[f"patch_embed.proj.{j}.0.weight"], stride=2, padding=1),
                   f"patch_embed.proj.{j}.1")
            if i < len(STEM) - 1:
                x = F.gelu(x)
        x = x.flatten(2).transpose(1, 2) + pos
        for i in range(cfg["depth"]):
            b = f"blocks.{i}"
            x = x + p[f"{b}.gamma1"] * xca(ln(x, f"{b}.norm1"), f"{b}.attn")
            x = x + p[f"{b}.gamma3"] * lpi(ln(x, f"{b}.norm3"), f"{b}.local_mp")
            x = x + p[f"{b}.gamma2"] * mlp(ln(x, f"{b}.norm2"), f"{b}.mlp")
        x = torch.cat([p["cls_token"].expand(x.shape[0], -1, -1), x], dim=1)
        for i in range(cfg["cls_attn_layers"]):
            b = f"cls_attn_blocks.{i}"
            u = ln(x, f"{b}.norm1")
            a = class_attn(u, f"{b}.attn")
            rows = torch.zeros_like(u[:, 1:]) if "patch_rows_add" in without else u[:, 1:]
            x = ln(x + p[f"{b}.gamma1"] * torch.cat([a, rows], dim=1), f"{b}.norm2")
            a = p[f"{b}.gamma2"] * mlp(x[:, :1], f"{b}.mlp")
            rows = torch.zeros_like(x[:, 1:]) if "patch_rows_doubled" in without else x[:, 1:]
            x = x + torch.cat([a, rows], dim=1)
        return dense(ln(x[:, 0], "norm"), "head")

    return forward
