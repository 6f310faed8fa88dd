"""The repository's plain ConvNeXt, for the CPU tests: the port's
``models.convnext`` is held to it, and the benchmark's copy
(``h100bench/reference/convnext.py``, with its ``param_specs``) to it too.
Plain torch in fp32; it imports nothing of the port and no JAX.

Liu et al. 2022 (arXiv:2201.03545), torchvision's ``convnext_base`` layout
and parameter names, frozen. The input is NHWC in [0, 1], normalized by
the ImageNet mean and std. The stem is a 4x4 stride-4 convolution and a
LayerNorm over the channels at each pixel. A block of width C is z + γ ⊙
(W2 GELU(W1 LN(h) + b1) + b2), with h the 7x7 depthwise convolution of z
(padding 3, groups C, a bias), LN over the channels of each pixel, W1 of
shape 4C x C, the exact erf GELU, and γ (C, 1, 1) the layer scale. Between
stages a channel LayerNorm and a 2x2 stride-2 convolution take C to 2C.
The head is a LayerNorm of the map's mean over its pixels, then the Linear
to the classes. LayerNorm eps is ``layer_norm_eps`` (1e-6).

Departures from the paper and the official code, none in arithmetic: the
official code's "channels_first" LayerNorm (its own mean and variance over
axis 1) is the same normalization as the LayerNorm over the last axis of
the NHWC view used here; the classifier's LayerNorm acts on the pooled
vector, as in both; eval mode, so stochastic depth is the identity.
``model(..., without=...)`` leaves out ``"dwconv"`` (each block's
depthwise convolution: h = z), ``"layer_scale"`` (γ = 1),
``"downsample_norm"`` (the downsamples' LayerNorms) or ``"exact_gelu"``
(the tanh GELU in its place), for the tests' guard: each is a wrong
ConvNeXt.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
STEM, DOWN = 4, 2  # the stem's and the downsamples' kernel and stride


def model(params, cfg, without=()):
    """The frozen classifier: NHWC [0, 1] images -> logits; ``without``
    names the parts left out (see the module)."""
    dev = params["features.0.0.weight"].device
    mean = torch.tensor(MEAN, device=dev).reshape(1, 3, 1, 1)
    std = torch.tensor(STD, device=dev).reshape(1, 3, 1, 1)
    dims, k, eps = cfg["dims"], cfg["kernel_size"], cfg["layer_norm_eps"]
    approximate = "tanh" if "exact_gelu" in without else "none"

    def gelu(x):
        return F.gelu(x, approximate=approximate)

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
                h = x if "dwconv" in without else conv(x, f"{b}.block.0", padding=k // 2,
                                                       groups=d)
                m = dense(gelu(dense(ln(h.permute(0, 2, 3, 1), f"{b}.block.2"),
                                     f"{b}.block.3")), f"{b}.block.5")
                scale = 1.0 if "layer_scale" in without else params[f"{b}.layer_scale"]
                x = x + scale * m.permute(0, 3, 1, 2)
            if i < len(dims) - 1:
                m = f"features.{2 * i + 2}"
                y = x if "downsample_norm" in without else ln_channels(x, f"{m}.0")
                x = conv(y, f"{m}.1", stride=DOWN)
        return dense(ln(x.mean(dim=(2, 3)), "classifier.0"), "classifier.2")

    return forward
