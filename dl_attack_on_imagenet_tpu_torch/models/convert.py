"""JAX-side state -> the port's: victim variables and ADiL training state.

``state_dict_from_flax`` takes the JAX victim's ``{'params', 'batch_stats'}``
as nested dicts of numpy arrays and returns the ``state_dict`` of the
matching port module (torchvision names). Modules are mapped by their Flax
names: Flax numbers submodules ``Class_N`` in call order within each parent,
so ``Bottleneck_7`` is the eighth block whatever order the dict keys come
in. Convolution kernels go HWIO -> OIHW and dense kernels are transposed.

``train_state_from_jax`` takes a JAX ``AdilState`` with numpy leaves and
returns the port's ``TrainState``, so that both packages can start training
from one state (their random generators differ).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..attacks.adil_core import TrainState


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


def _adam_state(opt_state: Any) -> Any:
    """The ``scale_by_adam`` state (``count``, ``mu``, ``nu``) of an optax
    AdamW state, which is a tuple of one state per chained transform."""
    for node in opt_state:
        if all(hasattr(node, f) for f in ("count", "mu", "nu")):
            return node
    raise ValueError("no AdamW state found in the JAX optimizer state")


def train_state_from_jax(jax_state: Any, device: DeviceLike = None) -> TrainState:
    """The port's ``TrainState`` for a JAX ``AdilState`` with numpy leaves.

    Reads ``d``, ``v``, ``epoch`` and the AdamW moments and step counts of
    either optimizer layout: one joint optax state over ``{"d", "v"}``
    (``gd`` mode, one count for both halves) or a dict ``{"d": ..., "v":
    ...}`` of one optax state each (``alter`` mode). ``device`` defaults to
    CUDA and raises where there is none; pass ``device="cpu"`` for the CPU.
    """
    opt = jax_state.opt_state
    if isinstance(opt, dict):  # alter
        d_adam, v_adam = _adam_state(opt["d"]), _adam_state(opt["v"])
        d_mu, d_nu, v_mu, v_nu = d_adam.mu, d_adam.nu, v_adam.mu, v_adam.nu
    else:
        d_adam = v_adam = _adam_state(opt)
        d_mu, d_nu, v_mu, v_nu = d_adam.mu["d"], d_adam.nu["d"], v_adam.mu["v"], v_adam.nu["v"]
    dev = resolve_device(device)
    flat = (np.shape(jax_state.d)[0], -1)
    to = lambda a, shape: _tensor(a).reshape(shape).to(dev)
    return TrainState(
        d=to(jax_state.d, flat), d_mu=to(d_mu, flat), d_nu=to(d_nu, flat),
        v=to(jax_state.v, np.shape(jax_state.v)), v_mu=to(v_mu, np.shape(v_mu)),
        v_nu=to(v_nu, np.shape(v_nu)),
        d_count=int(np.asarray(d_adam.count)), v_count=int(np.asarray(v_adam.count)),
        epoch=int(np.asarray(jax_state.epoch)))
