"""Plain ConvNeXt (Liu et al. 2022, arXiv:2201.03545; torchvision's
``convnext_base`` layout and parameter names), frozen.

The input is NHWC in [0, 1], normalized by the ImageNet mean and std. The
stem is a 4x4 stride-4 convolution and a LayerNorm over the channels at
each pixel. A block of width C is z + γ ⊙ (W2 GELU(W1 LN(h) + b1) + b2),
with h the 7x7 depthwise convolution of z (padding 3, groups C, a bias),
LN over the channels of each pixel, W1 of shape 4C x C, the exact erf
GELU, and γ (C, 1, 1) the layer scale. Between stages a channel LayerNorm
and a 2x2 stride-2 convolution take C to 2C. The head is a LayerNorm of
the map's mean over its pixels, then the Linear to the classes.
LayerNorm eps is ``layer_norm_eps`` (1e-6). All in fp32, with the
convolutions in contiguous NCHW and the per-pixel work on NHWC rows.

Departures from the paper and the official code, none in arithmetic: the
official code's "channels_first" LayerNorm (its own mean and variance over
axis 1) is the same normalization as the LayerNorm over the last axis of
the NHWC view used here; the classifier's LayerNorm acts on the pooled
vector, as in both; eval mode, so stochastic depth is the identity. The
layer scale is a constant of the configuration (``weights.layer_scale``),
not the published initial value of 1e-6, under which every block would be
close to the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
STEM, DOWN = 4, 2  # the stem's and the downsamples' kernel and stride


def param_specs(cfg):
    """(name, shape, init) of every tensor, in the ``state_dict``'s order:
    every matrix and kernel N(0, 1/fan_in) (LeCun normal; a depthwise
    kernel's fan-in is its k² taps), biases 0, LayerNorms at 1 and 0, each
    layer scale at ``weights.layer_scale``, the head N(0, ``head_std``)."""
    dims, k, r = cfg["dims"], cfg["kernel_size"], cfg["mlp_ratio"]
    specs = []

    def ln(name, d):
        specs.extend([(f"{name}.weight", (d,), ("const", 1.0)),
                      (f"{name}.bias", (d,), ("const", 0.0))])

    def conv(name, cout, cin, size):
        specs.extend([(f"{name}.weight", (cout, cin, size, size),
                       ("normal", math.sqrt(1.0 / (cin * size * size)))),
                      (f"{name}.bias", (cout,), ("const", 0.0))])

    def dense(name, cout, cin):
        specs.extend([(f"{name}.weight", (cout, cin), ("normal", math.sqrt(1.0 / cin))),
                      (f"{name}.bias", (cout,), ("const", 0.0))])

    conv("features.0.0", dims[0], 3, STEM)
    ln("features.0.1", dims[0])
    for i, (d, depth) in enumerate(zip(dims, cfg["depths"])):
        for j in range(depth):
            b = f"features.{2 * i + 1}.{j}"
            specs.append((f"{b}.layer_scale", (d, 1, 1), ("const", cfg["weights"]["layer_scale"])))
            conv(f"{b}.block.0", d, 1, k)
            ln(f"{b}.block.2", d)
            dense(f"{b}.block.3", r * d, d)
            dense(f"{b}.block.5", d, r * d)
        if i < len(dims) - 1:
            ln(f"features.{2 * i + 2}.0", d)
            conv(f"features.{2 * i + 2}.1", dims[i + 1], d, DOWN)
    ln("classifier.0", dims[-1])
    specs.extend([("classifier.2.weight", (cfg["num_classes"], dims[-1]),
                   ("normal", cfg["weights"]["head_std"])),
                  ("classifier.2.bias", (cfg["num_classes"],), ("const", 0.0))])
    return specs


def model(params, cfg):
    """The frozen classifier: NHWC [0, 1] images -> logits."""
    dev = params["features.0.0.weight"].device
    mean = torch.tensor(MEAN, device=dev).reshape(1, 3, 1, 1)
    std = torch.tensor(STD, device=dev).reshape(1, 3, 1, 1)
    dims, k, eps = cfg["dims"], cfg["kernel_size"], cfg["layer_norm_eps"]

    def ln(x, name):
        """LayerNorm over the last axis."""
        return F.layer_norm(x, (x.shape[-1],), params[f"{name}.weight"], params[f"{name}.bias"],
                            eps)

    def ln_channels(x, name):
        """LayerNorm over the channels of an NCHW map, contiguous NCHW out."""
        return ln(x.permute(0, 2, 3, 1), name).permute(0, 3, 1, 2).contiguous()

    def dense(x, name):
        return F.linear(x, params[f"{name}.weight"], params[f"{name}.bias"])

    def conv(x, name, **kw):
        return F.conv2d(x, params[f"{name}.weight"], params[f"{name}.bias"], **kw)

    def forward(images):
        x = (images.permute(0, 3, 1, 2).contiguous() - mean) / std
        x = ln_channels(conv(x, "features.0.0", stride=STEM), "features.0.1")
        for i, (d, depth) in enumerate(zip(dims, cfg["depths"])):
            for j in range(depth):
                b = f"features.{2 * i + 1}.{j}"
                h = conv(x, f"{b}.block.0", padding=k // 2, groups=d)
                m = dense(F.gelu(dense(ln(h.permute(0, 2, 3, 1), f"{b}.block.2"),
                                       f"{b}.block.3")), f"{b}.block.5")
                x = x + params[f"{b}.layer_scale"] * m.permute(0, 3, 1, 2)
            if i < len(dims) - 1:
                m = f"features.{2 * i + 2}"
                x = conv(ln_channels(x, f"{m}.0"), f"{m}.1", stride=DOWN)
        return dense(ln(x.mean(dim=(2, 3)), "classifier.0"), "classifier.2")

    return forward
