"""Plain Vision Transformer (Dosovitskiy et al. 2021; torchvision's
``vit_b_16`` layout and parameter names), frozen.

Pre-norm encoder blocks with LayerNorm eps 1e-6, exact erf GELU, attention
written out as softmax(q kᵀ / sqrt(head_dim)) v with q, k and v packed in
``in_proj_weight``, the head on the class token. The input is NHWC in
[0, 1], normalized by the ImageNet mean and std.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6


def param_specs(cfg):
    """(name, shape, init) of every tensor: every matrix N(0, 1/fan_in)
    (LeCun normal), biases 0, LayerNorms at 1 and 0, the class token and
    the position embedding N(0, 0.02), the head N(0, ``head_std``)."""
    d, mlp, p = cfg["hidden_dim"], cfg["mlp_dim"], cfg["patch_size"]
    seq = (cfg["input_size"] // p) ** 2 + 1
    specs = [("conv_proj.weight", (d, 3, p, p), ("normal", math.sqrt(1.0 / (3 * p * p)))),
             ("conv_proj.bias", (d,), ("const", 0.0)),
             ("class_token", (1, 1, d), ("normal", 0.02)),
             ("encoder.pos_embedding", (1, seq, d), ("normal", 0.02))]

    def ln(name):
        specs.extend([(f"{name}.weight", (d,), ("const", 1.0)), (f"{name}.bias", (d,), ("const", 0.0))])

    def dense(name, cout, cin):
        specs.extend([(f"{name}.weight", (cout, cin), ("normal", math.sqrt(1.0 / cin))),
                      (f"{name}.bias", (cout,), ("const", 0.0))])

    for i in range(cfg["num_layers"]):
        b = f"encoder.layers.encoder_layer_{i}"
        ln(f"{b}.ln_1")
        specs.extend([(f"{b}.self_attention.in_proj_weight", (3 * d, d), ("normal", math.sqrt(1.0 / d))),
                      (f"{b}.self_attention.in_proj_bias", (3 * d,), ("const", 0.0))])
        dense(f"{b}.self_attention.out_proj", d, d)
        ln(f"{b}.ln_2")
        dense(f"{b}.mlp.0", mlp, d)
        dense(f"{b}.mlp.3", d, mlp)
    ln("encoder.ln")
    specs.extend([("heads.head.weight", (cfg["num_classes"], d), ("normal", cfg["weights"]["head_std"])),
                  ("heads.head.bias", (cfg["num_classes"],), ("const", 0.0))])
    return specs


def model(params, cfg):
    """The frozen classifier: NHWC [0, 1] images -> logits."""
    d, heads, p = cfg["hidden_dim"], cfg["num_heads"], cfg["patch_size"]
    hd = d // heads
    dev = params["conv_proj.weight"].device
    mean = torch.tensor(MEAN, device=dev).reshape(1, 3, 1, 1)
    std = torch.tensor(STD, device=dev).reshape(1, 3, 1, 1)

    def ln(x, name):
        return F.layer_norm(x, (d,), params[f"{name}.weight"], params[f"{name}.bias"], LN_EPS)

    def dense(x, name):
        return F.linear(x, params[f"{name}.weight"], params[f"{name}.bias"])

    def attention(x, name):
        n, length, _ = x.shape
        qkv = F.linear(x, params[f"{name}.in_proj_weight"], params[f"{name}.in_proj_bias"])
        q, k, v = qkv.reshape(n, length, 3, heads, hd).permute(2, 0, 3, 1, 4)
        w = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(hd), dim=-1)
        return dense((w @ v).transpose(1, 2).reshape(n, length, d), f"{name}.out_proj")

    def forward(images):
        x = (images.permute(0, 3, 1, 2).contiguous() - mean) / std
        x = F.conv2d(x, params["conv_proj.weight"], params["conv_proj.bias"], stride=p)
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([params["class_token"].expand(x.shape[0], -1, -1), x], dim=1)
        x = x + params["encoder.pos_embedding"]
        for i in range(cfg["num_layers"]):
            b = f"encoder.layers.encoder_layer_{i}"
            x = x + attention(ln(x, f"{b}.ln_1"), f"{b}.self_attention")
            x = x + dense(F.gelu(dense(ln(x, f"{b}.ln_2"), f"{b}.mlp.0")), f"{b}.mlp.3")
        return dense(ln(x, "encoder.ln")[:, 0], "heads.head")

    return forward
