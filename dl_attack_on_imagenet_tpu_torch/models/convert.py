"""Flax victim variables -> the port's ``state_dict``.

``state_dict_from_flax`` takes the JAX victim's ``{'params', 'batch_stats'}``
as nested dicts of numpy arrays and returns the ``state_dict`` of the
matching port module (torchvision names). Modules are mapped by their Flax
names: Flax numbers submodules ``Class_N`` in call order within each parent,
so ``Bottleneck_7`` is the eighth block whatever order the dict keys come
in. Convolution kernels go HWIO -> OIHW and dense kernels are transposed.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List

import numpy as np
import torch


def _numbered(tree: Dict, cls: str) -> List[str]:
    """Keys ``cls_N`` of ``tree``, in the order of N."""
    pattern = re.compile(rf"{cls}_(\d+)$")
    keys = [k for k in tree if pattern.match(k)]
    return sorted(keys, key=lambda k: int(pattern.match(k).group(1)))


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32)  # a contiguous copy


def _conv(out: Dict, name: str, p: Dict) -> None:
    out[f"{name}.weight"] = _tensor(np.transpose(p["kernel"], (3, 2, 0, 1)))
    if "bias" in p:
        out[f"{name}.bias"] = _tensor(p["bias"])


def _dense(out: Dict, name: str, p: Dict) -> None:
    out[f"{name}.weight"] = _tensor(np.asarray(p["kernel"]).T)
    out[f"{name}.bias"] = _tensor(p["bias"])


def _bn(out: Dict, name: str, p: Dict, stats: Dict) -> None:
    out[f"{name}.weight"] = _tensor(p["scale"])
    out[f"{name}.bias"] = _tensor(p["bias"])
    out[f"{name}.running_mean"] = _tensor(stats["mean"])
    out[f"{name}.running_var"] = _tensor(stats["var"])
    out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _conv_bn(out: Dict, conv: str, bn: str, p: Dict, stats: Dict) -> None:
    if "Conv_0" not in p or "BatchNorm_0" not in p:
        raise ValueError("folded-BN victims are not ported yet")
    _conv(out, conv, p["Conv_0"])
    _bn(out, bn, p["BatchNorm_0"], stats["BatchNorm_0"])


def _resnet(params: Dict, stats: Dict) -> Dict[str, torch.Tensor]:
    if "ConvBN_0" not in params:
        raise ValueError("space-to-depth stems are not ported yet")
    out: Dict[str, torch.Tensor] = {}
    _conv_bn(out, "conv1", "bn1", params["ConvBN_0"], stats["ConvBN_0"])
    cls = "Bottleneck" if _numbered(params, "Bottleneck") else "BasicBlock"
    n_convs = 3 if cls == "Bottleneck" else 2
    seen: Dict[int, int] = {}
    for key in _numbered(params, cls):
        p, s = params[key], stats[key]
        # The stage follows from the block's output width: 64 * 2**stage
        # channels (times 4 for a bottleneck).
        width = np.shape(p[f"ConvBN_{n_convs - 1}"]["Conv_0"]["kernel"])[-1]
        stage = int(round(math.log2(width // (4 if cls == "Bottleneck" else 1) // 64)))
        j = seen.get(stage, 0)
        seen[stage] = j + 1
        prefix = f"layer{stage + 1}.{j}"
        for c in range(n_convs):
            _conv_bn(out, f"{prefix}.conv{c + 1}", f"{prefix}.bn{c + 1}",
                     p[f"ConvBN_{c}"], s[f"ConvBN_{c}"])
        if f"ConvBN_{n_convs}" in p:
            _conv_bn(out, f"{prefix}.downsample.0", f"{prefix}.downsample.1",
                     p[f"ConvBN_{n_convs}"], s[f"ConvBN_{n_convs}"])
    _dense(out, "fc", params["Dense_0"])
    return out


def state_dict_from_flax(variables_np: Dict) -> Dict[str, torch.Tensor]:
    """The port module's ``state_dict`` for a JAX victim's variables.

    Supports the ResNets (18/34/50) and the tiny CNN.
    """
    params = variables_np["params"]
    if "Conv_0" in params and "Dense_0" in params and len(params) == 3:
        out: Dict[str, torch.Tensor] = {}
        _conv(out, "conv0", params["Conv_0"])
        _conv(out, "conv1", params["Conv_1"])
        _dense(out, "fc", params["Dense_0"])
        return out
    if _numbered(params, "Bottleneck") or _numbered(params, "BasicBlock"):
        return _resnet(params, variables_np.get("batch_stats", {}))
    raise ValueError(f"unrecognised victim variables: {sorted(params)}")
