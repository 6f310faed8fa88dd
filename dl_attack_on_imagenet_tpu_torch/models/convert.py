"""Weights and state into the port: victim variables and ADiL training state
from the JAX package, victim weights from torchvision checkpoints.

``state_dict_from_flax`` takes the JAX victim's ``{'params', 'batch_stats'}``
as nested dicts of numpy arrays and returns the ``state_dict`` of the
matching port module (torchvision names). Modules are mapped by their Flax
names: Flax numbers submodules ``Class_N`` in call order within each parent,
so ``Bottleneck_7`` is the eighth block whatever order the dict keys come
in. Convolution kernels go HWIO -> OIHW and dense kernels are transposed;
ViT's per-head query, key and value kernels are packed into
``in_proj_weight``. A space-to-depth stem (``S2DStem_0``, the JAX package's
``stem_s2d`` or ``blocked_input`` build) keeps the plain (7, 7, 3, F)
kernel and its BatchNorm, which map onto the stem's torchvision names
unchanged: the result loads into the port's build with or without
``stem_s2d``.

``load_torch_checkpoint`` loads a torchvision ``state_dict`` saved with
``torch.save`` into a port victim, less the auxiliary heads that the
victims omit (GoogLeNet's ``aux1``/``aux2``, Inception's ``AuxLogits``).

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
from .vgg import CFGS as _VGG_CFGS


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


def _ln(out: Dict, name: str, p: Dict) -> None:
    out[f"{name}.weight"] = _tensor(p["scale"])
    out[f"{name}.bias"] = _tensor(p["bias"])


def _conv_bn(out: Dict, conv: str, bn: str, p: Dict, stats: Dict) -> None:
    if "Conv_0" not in p or "BatchNorm_0" not in p:
        raise ValueError("convert the unfolded victim and fold the port's "
                         "(models.fold.fold_victim)")
    _conv(out, conv, p["Conv_0"])
    _bn(out, bn, p["BatchNorm_0"], stats["BatchNorm_0"])


def _basic_convs(out: Dict, prefix: str, names, params: Dict, stats: Dict) -> None:
    """``ConvBN_j`` of ``params`` into the ``BasicConv2d`` named ``names[j]``."""
    for j, name in enumerate(names):
        _conv_bn(out, f"{prefix}{name}.conv", f"{prefix}{name}.bn",
                 params[f"ConvBN_{j}"], stats[f"ConvBN_{j}"])


def _s2d_stem(out: Dict, conv: str, bn: str, params: Dict, stats: Dict) -> bool:
    """The ``S2DStem_0`` of ``params``, where there is one, into the plain
    stem's ``conv`` and ``bn``; returns whether there was one."""
    if "S2DStem_0" not in params:
        return False
    p = params["S2DStem_0"]
    _conv_bn(out, conv, bn, {"Conv_0": {"kernel": p["kernel"]}, **p},
             stats.get("S2DStem_0", {}))
    return True


def _resnet(params: Dict, stats: Dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if not _s2d_stem(out, "conv1", "bn1", params, stats):
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


def _densenet(params: Dict, stats: Dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    # With an S2D stem the stem's BatchNorm is inside it, and the last one is
    # BatchNorm_0 rather than BatchNorm_1.
    final = "BatchNorm_0"
    if not _s2d_stem(out, "features.conv0", "features.norm0", params, stats):
        _conv(out, "features.conv0", params["Conv_0"])
        _bn(out, "features.norm0", params["BatchNorm_0"], stats["BatchNorm_0"])
        final = "BatchNorm_1"
    block, layer, prev = 0, 0, None
    for key in _numbered(params, "DenseLayer"):
        p, s = params[key], stats[key]
        # Flax numbers the layers across blocks: a layer opens a new block
        # where its input is not the previous layer's input plus its growth.
        cin = np.shape(p["BatchNorm_0"]["scale"])[0]
        growth = np.shape(p["Conv_1"]["kernel"])[-1]
        if prev is None or cin != prev + growth:
            block, layer = block + 1, 0
        layer, prev = layer + 1, cin
        prefix = f"features.denseblock{block}.denselayer{layer}"
        _bn(out, f"{prefix}.norm1", p["BatchNorm_0"], s["BatchNorm_0"])
        _conv(out, f"{prefix}.conv1", p["Conv_0"])
        _bn(out, f"{prefix}.norm2", p["BatchNorm_1"], s["BatchNorm_1"])
        _conv(out, f"{prefix}.conv2", p["Conv_1"])
    for t, key in enumerate(_numbered(params, "Transition")):
        _bn(out, f"features.transition{t + 1}.norm", params[key]["BatchNorm_0"],
            stats[key]["BatchNorm_0"])
        _conv(out, f"features.transition{t + 1}.conv", params[key]["Conv_0"])
    _bn(out, "features.norm5", params[final], stats[final])
    _dense(out, "classifier", params["Dense_0"])
    return out


def _mobilenet(params: Dict, stats: Dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _conv_bn(out, "features.0.0", "features.0.1", params["ConvBN_0"], stats["ConvBN_0"])
    blocks = _numbered(params, "InvertedResidual")
    for i, key in enumerate(blocks):
        p, s = params[key], stats[key]
        convs = _numbered(p, "ConvBN")
        prefix = f"features.{i + 1}.conv"
        for j, c in enumerate(convs[:-1]):  # ConvBNReLU6 blocks: (conv, BN) inside
            _conv_bn(out, f"{prefix}.{j}.0", f"{prefix}.{j}.1", p[c], s[c])
        j = len(convs) - 1  # the linear projection: conv and BN side by side
        _conv_bn(out, f"{prefix}.{j}", f"{prefix}.{j + 1}", p[convs[-1]], s[convs[-1]])
    last = f"features.{len(blocks) + 1}"
    _conv_bn(out, f"{last}.0", f"{last}.1", params["ConvBN_1"], stats["ConvBN_1"])
    _dense(out, "classifier.1", params["Dense_0"])
    return out


_GOOGLENET_BLOCKS = ("3a", "3b", "4a", "4b", "4c", "4d", "4e", "5a", "5b")
_GOOGLENET_BRANCHES = ("branch1", "branch2.0", "branch2.1", "branch3.0", "branch3.1",
                       "branch4.1")


def _googlenet(params: Dict, stats: Dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if _s2d_stem(out, "conv1.conv", "conv1.bn", params, stats):
        _basic_convs(out, "", ("conv2", "conv3"), params, stats)
    else:
        _basic_convs(out, "", ("conv1", "conv2", "conv3"), params, stats)
    for i, name in enumerate(_GOOGLENET_BLOCKS):
        key = f"InceptionBlock_{i}"
        _basic_convs(out, f"inception{name}.", _GOOGLENET_BRANCHES, params[key], stats[key])
    _dense(out, "fc", params["Dense_0"])
    return out


# Each Inception block's convolutions in the order the JAX module calls them.
_INCEPTION_BLOCKS = {
    "InceptionA": (("5b", "5c", "5d"), (
        "branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1", "branch3x3dbl_2",
        "branch3x3dbl_3", "branch_pool")),
    "InceptionB": (("6a",), ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2",
                             "branch3x3dbl_3")),
    "InceptionC": (("6b", "6c", "6d", "6e"), (
        "branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3", "branch7x7dbl_1",
        "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool")),
    "InceptionD": (("7a",), ("branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
                             "branch7x7x3_3", "branch7x7x3_4")),
    "InceptionE": (("7b", "7c"), (
        "branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_1",
        "branch3x3dbl_2", "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool")),
}


def _inception(params: Dict, stats: Dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _basic_convs(out, "", ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
                           "Conv2d_4a_3x3"), params, stats)
    for cls, (mixed, convs) in _INCEPTION_BLOCKS.items():
        for key, name in zip(_numbered(params, cls), mixed):
            _basic_convs(out, f"Mixed_{name}.", convs, params[key], stats[key])
    _dense(out, "fc", params["Dense_0"])
    return out


def _vgg(params: Dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    convs = iter(_numbered(params, "Conv"))
    n_convs = len(_numbered(params, "Conv"))
    cfg = next(c for c in _VGG_CFGS.values() if sum(v != "M" for v in c) == n_convs)
    index = 0  # torchvision's features: (conv, ReLU) a layer, one module a pool
    for item in cfg:
        if item != "M":
            _conv(out, f"features.{index}", params[next(convs)])
        index += 1 if item == "M" else 2
    for j, key in enumerate(_numbered(params, "Dense")):
        _dense(out, f"classifier.{3 * j}", params[key])
    return out


def _vit(params: Dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "conv_proj", params["Conv_0"])
    out["class_token"] = _tensor(params["cls_token"])
    out["encoder.pos_embedding"] = _tensor(params["pos_embedding"])
    for i, key in enumerate(_numbered(params, "EncoderBlock")):
        p, pre = params[key], f"encoder.layers.encoder_layer_{i}"
        _ln(out, f"{pre}.ln_1", p["LayerNorm_0"])
        attn = p["MultiHeadDotProductAttention_0"]
        d = np.shape(attn["query"]["kernel"])[0]
        # (d, heads, head_dim) kernels -> rows of the packed (3d, d) weight.
        qkv = ("query", "key", "value")
        out[f"{pre}.self_attention.in_proj_weight"] = _tensor(np.concatenate(
            [np.reshape(attn[n]["kernel"], (d, d)).T for n in qkv]))
        out[f"{pre}.self_attention.in_proj_bias"] = _tensor(np.concatenate(
            [np.reshape(attn[n]["bias"], (d,)) for n in qkv]))
        out[f"{pre}.self_attention.out_proj.weight"] = _tensor(
            np.reshape(attn["out"]["kernel"], (d, d)).T)
        out[f"{pre}.self_attention.out_proj.bias"] = _tensor(attn["out"]["bias"])
        _ln(out, f"{pre}.ln_2", p["LayerNorm_1"])
        _dense(out, f"{pre}.mlp.0", p["MlpBlock_0"]["Dense_0"])
        _dense(out, f"{pre}.mlp.3", p["MlpBlock_0"]["Dense_1"])
    _ln(out, "encoder.ln", params["LayerNorm_0"])
    _dense(out, "heads.head", params["Dense_0"])
    return out


# A family's first numbered submodule -> its converter.
_FAMILIES = (("Bottleneck", _resnet), ("BasicBlock", _resnet), ("DenseLayer", _densenet),
             ("InvertedResidual", _mobilenet), ("InceptionBlock", _googlenet),
             ("InceptionA", _inception))


def state_dict_from_flax(variables_np: Dict) -> Dict[str, torch.Tensor]:
    """The port module's ``state_dict`` for a JAX victim's variables.

    Supports every victim of the registry: the ResNets, DenseNet,
    MobileNetV2, GoogLeNet, Inception-v3, VGG, ViT and the tiny CNN.
    """
    params = variables_np["params"]
    stats = variables_np.get("batch_stats", {})
    if "Conv_0" in params and "Dense_0" in params and len(params) == 3:
        out: Dict[str, torch.Tensor] = {}
        _conv(out, "conv0", params["Conv_0"])
        _conv(out, "conv1", params["Conv_1"])
        _dense(out, "fc", params["Dense_0"])
        return out
    for cls, convert in _FAMILIES:
        if _numbered(params, cls):
            return convert(params, stats)
    if _numbered(params, "EncoderBlock"):
        return _vit(params)
    if _numbered(params, "Conv") and len(_numbered(params, "Dense")) == 3:
        return _vgg(params)
    raise ValueError(f"unrecognised victim variables: {sorted(params)}")


_AUX_PREFIXES = ("AuxLogits.", "aux1.", "aux2.")


def load_torch_checkpoint(path: str, victim, vit: bool = False):
    """Load a ``torch.save``d torchvision ``state_dict`` into ``victim`` in
    place and return it. The port's modules use torchvision's names, so no
    conversion is needed; the auxiliary heads' keys, which the victims do
    not have, are dropped first, as the JAX package drops them. ``vit``, the
    JAX package's switch to its ViT converter, is accepted and changes
    nothing: the port's ViT has torchvision's names too."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    victim.net.load_state_dict({
        k: v for k, v in state_dict.items()
        if not any(k.startswith(p) or f".{p}" in k for p in _AUX_PREFIXES)})
    return victim


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
