"""Plain ResNet with bottleneck blocks (He et al. 2016, torchvision's
``resnet50`` layout and parameter names), frozen, BatchNorm in eval mode.

Departures from the paper: none in the forward pass. The stride sits on
the 3x3 convolution of a block (torchvision's "ResNet v1.5"), as in the
program's victim. The input is NHWC in [0, 1], normalized by the ImageNet
mean and std, and computed in plain NCHW layout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _blocks(cfg):
    """(prefix, in, planes, stride, has_downsample) of every block."""
    inplanes, width, exp = cfg["width"], cfg["width"], cfg["expansion"]
    for i, size in enumerate(cfg["stage_sizes"]):
        planes = width * 2 ** i
        for j in range(size):
            stride = 2 if i > 0 and j == 0 else 1
            down = stride != 1 or inplanes != planes * exp
            yield f"layer{i + 1}.{j}", inplanes, planes, stride, down
            inplanes = planes * exp


def param_specs(cfg):
    """(name, shape, init) of every tensor, init ("normal", std) or
    ("const", value), as the configuration's ``weights`` section sets them:
    He-normal convolutions over their fan-in, BatchNorm at its identity
    statistics with the last BatchNorm of each residual branch scaled by
    ``residual_bn_gamma``, and the classifier N(0, ``fc_std``)."""
    w = cfg["weights"]
    specs = []

    def conv(name, cout, cin, k):
        specs.append((f"{name}.weight", (cout, cin, k, k), ("normal", math.sqrt(2.0 / (cin * k * k)))))

    def bn(name, c, gamma=1.0):
        specs.extend([(f"{name}.weight", (c,), ("const", gamma)),
                      (f"{name}.bias", (c,), ("const", 0.0)),
                      (f"{name}.running_mean", (c,), ("const", 0.0)),
                      (f"{name}.running_var", (c,), ("const", 1.0))])

    conv("conv1", cfg["width"], 3, 7)
    bn("bn1", cfg["width"])
    exp = cfg["expansion"]
    for p, cin, planes, _, down in _blocks(cfg):
        conv(f"{p}.conv1", planes, cin, 1)
        bn(f"{p}.bn1", planes)
        conv(f"{p}.conv2", planes, planes, 3)
        bn(f"{p}.bn2", planes)
        conv(f"{p}.conv3", planes * exp, planes, 1)
        bn(f"{p}.bn3", planes * exp, w["residual_bn_gamma"])
        if down:
            conv(f"{p}.downsample.0", planes * exp, cin, 1)
            bn(f"{p}.downsample.1", planes * exp)
    features = cfg["width"] * 2 ** (len(cfg["stage_sizes"]) - 1) * exp
    specs.append(("fc.weight", (cfg["num_classes"], features), ("normal", w["fc_std"])))
    specs.append(("fc.bias", (cfg["num_classes"],), ("const", 0.0)))
    return specs


def model(params, cfg):
    """The frozen classifier: NHWC [0, 1] images -> logits."""
    eps = cfg["bn_eps"]
    dev = params["fc.weight"].device
    mean = torch.tensor(MEAN, device=dev).reshape(1, 3, 1, 1)
    std = torch.tensor(STD, device=dev).reshape(1, 3, 1, 1)

    def bn(x, name):
        return F.batch_norm(x, params[f"{name}.running_mean"], params[f"{name}.running_var"],
                            params[f"{name}.weight"], params[f"{name}.bias"], False, 0.0, eps)

    def conv(x, name, stride=1):
        w = params[f"{name}.weight"]
        return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)

    def forward(images):
        x = (images.permute(0, 3, 1, 2).contiguous() - mean) / std
        x = F.relu(bn(conv(x, "conv1", 2), "bn1"))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for p, _, _, stride, down in _blocks(cfg):
            y = F.relu(bn(conv(x, f"{p}.conv1"), f"{p}.bn1"))
            y = F.relu(bn(conv(y, f"{p}.conv2", stride), f"{p}.bn2"))
            y = bn(conv(y, f"{p}.conv3"), f"{p}.bn3")
            if down:
                x = bn(conv(x, f"{p}.downsample.0", stride), f"{p}.downsample.1")
            x = F.relu(y + x)
        return F.linear(x.mean(dim=(2, 3)), params["fc.weight"], params["fc.bias"])

    return forward
