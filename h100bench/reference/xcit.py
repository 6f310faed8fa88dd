"""Plain XCiT at patch 16 (El-Nouby et al. 2021, arXiv:2106.09681; timm's
``xcit.py`` layout and parameter names), frozen.

The input is NHWC in [0, 1], normalized by the ImageNet mean and std. The
stem is four 3x3 stride-2 convolutions without bias, 3 -> C/8 -> C/4 ->
C/2 -> C, each followed by a BatchNorm (running statistics, eps
``batch_norm_eps``) and the first three by the exact GELU; the map is read
as N tokens of width C, and a Fourier encoding of each token's (row,
column) through a 1x1 convolution 2·``pos_hidden_dim`` -> C is added (it
depends on the map's size alone, so it is computed once, with the model).
Each of ``depth`` blocks is x + γ1 XCA(LN1 x), x + γ3 LPI(LN3 x), x + γ2
MLP(LN2 x):

- XCA: q, k, v of (B, heads, d, N); q and k l2-normalized over the tokens
  (eps 1e-12); A = softmax(τ_h q̂ k̂ᵀ), d x d; out = (A v) back to (B, N, C),
  then the projection.
- LPI: the tokens as a (B, C, h, w) map, a 3x3 depthwise convolution with
  a bias, GELU, BatchNorm, a 3x3 depthwise convolution with a bias, back
  to tokens.
- MLP: Linear C -> ``mlp_ratio``·C, the exact GELU, Linear back.

Then a class token is put before the tokens and each of
``cls_attn_layers`` class-attention layers computes u = LN1(x); a₀ = the
projection of softmax(q₀ kᵀ / sqrt(d)) v with q₀ from u's class row and
k, v from all of u's rows; y = LN2(x + γ1 [a₀; u's patch rows]) on every
row; out = y + [γ2 MLP(y₀); y's patch rows]. The head is a LayerNorm and
the Linear on the class row. LayerNorm eps is ``layer_norm_eps``.

Departures from the paper and the official code, none in arithmetic: the
official class attention packs q, k and v in one Linear, timm's (whose
names are used here) in three; the final LayerNorm is computed on the
class row alone, the only row the head reads; eval mode, so dropout and
stochastic depth are the identity. The layer scales, the temperatures,
the BatchNorms' running statistics and the LayerNorms' biases are drawn
from the configuration's ``weights``, not the published initial values,
under which every block would be close to the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
STEM = (0, 2, 4, 6)  # the stem's convolutions in ``patch_embed.proj``


def param_specs(cfg):
    """(name, shape, init) of every tensor, in the ``state_dict``'s order:
    every matrix and kernel N(0, 1/fan_in) (LeCun normal; a depthwise
    kernel's fan-in is its k² taps), biases 0, LayerNorm weights 1 and
    biases N(0, ``ln_bias_std``), BatchNorm weights 1, biases 0, running
    means N(0, ``bn_mean_std``) and running variances ``bn_var``, each
    temperature ``temperature``, the class token N(0, ``cls_token_std``),
    each layer scale its ``layer_scale`` entry, the head N(0,
    ``head_std``)."""
    c, r, k = cfg["embed_dim"], cfg["mlp_ratio"], cfg["lpi_kernel_size"]
    w = cfg["weights"]
    scale = w["layer_scale"]
    specs = [("cls_token", (1, 1, c), ("normal", w["cls_token_std"]))]

    def ln(name):
        specs.extend([(f"{name}.weight", (c,), ("const", 1.0)),
                      (f"{name}.bias", (c,), ("normal", w["ln_bias_std"]))])

    def bn(name, d):
        specs.extend([(f"{name}.weight", (d,), ("const", 1.0)),
                      (f"{name}.bias", (d,), ("const", 0.0)),
                      (f"{name}.running_mean", (d,), ("normal", w["bn_mean_std"])),
                      (f"{name}.running_var", (d,), ("const", w["bn_var"]))])

    def conv(name, cout, cin, size, bias=True):
        specs.append((f"{name}.weight", (cout, cin, size, size),
                      ("normal", math.sqrt(1.0 / (cin * size * size)))))
        if bias:
            specs.append((f"{name}.bias", (cout,), ("const", 0.0)))

    def dense(name, cout, cin):
        specs.extend([(f"{name}.weight", (cout, cin), ("normal", math.sqrt(1.0 / cin))),
                      (f"{name}.bias", (cout,), ("const", 0.0))])

    widths = [3, c // 8, c // 4, c // 2, c]
    for i, j in enumerate(STEM):
        conv(f"patch_embed.proj.{j}.0", widths[i + 1], widths[i], 3, bias=False)
        bn(f"patch_embed.proj.{j}.1", widths[i + 1])
    conv("pos_embed.token_projection", c, 2 * cfg["pos_hidden_dim"], 1)
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        specs.extend((f"{b}.{g}", (c,), ("const", scale[g]))
                     for g in ("gamma1", "gamma3", "gamma2"))
        ln(f"{b}.norm1")
        specs.append((f"{b}.attn.temperature", (cfg["num_heads"], 1, 1),
                      ("const", w["temperature"])))
        dense(f"{b}.attn.qkv", 3 * c, c)
        dense(f"{b}.attn.proj", c, c)
        ln(f"{b}.norm3")
        conv(f"{b}.local_mp.conv1", c, 1, k)
        bn(f"{b}.local_mp.bn", c)
        conv(f"{b}.local_mp.conv2", c, 1, k)
        ln(f"{b}.norm2")
        dense(f"{b}.mlp.fc1", r * c, c)
        dense(f"{b}.mlp.fc2", c, r * c)
    for i in range(cfg["cls_attn_layers"]):
        b = f"cls_attn_blocks.{i}"
        specs.extend((f"{b}.{g}", (c,), ("const", scale[f"cls_{g}"])) for g in ("gamma1", "gamma2"))
        ln(f"{b}.norm1")
        for p in ("q", "k", "v", "proj"):
            dense(f"{b}.attn.{p}", c, c)
        ln(f"{b}.norm2")
        dense(f"{b}.mlp.fc1", r * c, c)
        dense(f"{b}.mlp.fc2", c, r * c)
    ln("norm")
    specs.extend([("head.weight", (cfg["num_classes"], c), ("normal", w["head_std"])),
                  ("head.bias", (cfg["num_classes"],), ("const", 0.0))])
    return specs


def fourier(side: int, hidden: int, temperature: float, device) -> torch.Tensor:
    """The (1, 2·hidden, side, side) Fourier features of the token map:
    for each of y (rows) then x (columns), the coordinate 1..side over
    side + 1e-6 times 2π, over temperature^(2⌊i/2⌋/hidden), sines at even
    i and cosines at odd i, interleaved."""
    t = torch.arange(1, side + 1, dtype=torch.float32, device=device)
    t = t / (side + 1e-6) * (2 * math.pi)
    i = torch.arange(hidden, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(i, 2, rounding_mode="floor") / hidden)
    a = t[:, None] / dim_t  # (side, hidden)
    enc = torch.stack([a[:, 0::2].sin(), a[:, 1::2].cos()], dim=2).flatten(1)
    y = enc[:, None, :].expand(side, side, hidden)
    x = enc[None, :, :].expand(side, side, hidden)
    return torch.cat([y, x], dim=2).permute(2, 0, 1)[None].contiguous()


def model(params, cfg):
    """The frozen classifier: NHWC [0, 1] images -> logits."""
    p = params
    dev = p["head.weight"].device
    mean = torch.tensor(MEAN, device=dev).reshape(1, 3, 1, 1)
    std = torch.tensor(STD, device=dev).reshape(1, 3, 1, 1)
    c, heads = cfg["embed_dim"], cfg["num_heads"]
    d, k = c // heads, cfg["lpi_kernel_size"]
    side = cfg["input_size"] // cfg["patch_size"]
    ln_eps, bn_eps = cfg["layer_norm_eps"], cfg["batch_norm_eps"]

    def ln(x, name):
        return F.layer_norm(x, (c,), p[f"{name}.weight"], p[f"{name}.bias"], ln_eps)

    def bn(x, name):
        return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                            p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0, bn_eps)

    def dense(x, name):
        return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])

    def mlp(x, name):
        return dense(F.gelu(dense(x, f"{name}.fc1")), f"{name}.fc2")

    def xca(u, name):
        n = u.shape[0]
        qkv = dense(u, f"{name}.qkv").reshape(n, side * side, 3, heads, d).permute(2, 0, 3, 4, 1)
        q, kk, v = F.normalize(qkv[0], dim=-1), F.normalize(qkv[1], dim=-1), qkv[2]
        a = torch.softmax((q @ kk.transpose(-2, -1)) * p[f"{name}.temperature"], dim=-1)
        return dense((a @ v).permute(0, 3, 1, 2).reshape(n, side * side, c), f"{name}.proj")

    def dwconv(m, name):
        return F.conv2d(m, p[f"{name}.weight"], p[f"{name}.bias"], padding=k // 2, groups=c)

    def lpi(u, name):
        n = u.shape[0]
        m = dwconv(u.transpose(1, 2).reshape(n, c, side, side).contiguous(), f"{name}.conv1")
        m = dwconv(bn(F.gelu(m), f"{name}.bn"), f"{name}.conv2")
        return m.reshape(n, c, side * side).transpose(1, 2)

    def class_attn(u, name):
        n, rows, _ = u.shape
        q = dense(u[:, 0], f"{name}.q").reshape(n, heads, 1, d) * d ** -0.5
        kk = dense(u, f"{name}.k").reshape(n, rows, heads, d).transpose(1, 2)
        v = dense(u, f"{name}.v").reshape(n, rows, heads, d).transpose(1, 2)
        out = torch.softmax(q @ kk.transpose(-2, -1), dim=-1) @ v  # (n, heads, 1, d)
        return dense(out.reshape(n, 1, c), f"{name}.proj")

    pos = F.conv2d(fourier(side, cfg["pos_hidden_dim"], cfg["pos_temperature"], dev),
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
            x = ln(x + p[f"{b}.gamma1"] * torch.cat([class_attn(u, f"{b}.attn"), u[:, 1:]], dim=1),
                   f"{b}.norm2")
            x = x + torch.cat([p[f"{b}.gamma2"] * mlp(x[:, :1], f"{b}.mlp"), x[:, 1:]], dim=1)
        return dense(ln(x[:, 0], "norm"), "head")

    return forward
