"""Victim models: torch classifiers behind a frozen NHWC wrapper.

Port of ``dl_attack_on_imagenet_tpu/models/__init__.py``, with the same
registry: the ResNets, DenseNet, GoogLeNet, Inception-v3, MobileNetV2, VGG,
ViT and the tiny test CNN. A name picks a classifier, the ImageNet
normalization is prepended, and the result is a frozen function from [0, 1]
NHWC images to logits: eval mode, no weight gradients, weights in
``channels_last``. The ResNets, DenseNet and GoogLeNet take ``stem_s2d``
(their stem on 2x2 space-to-depth blocks); :func:`blocked_twin` gives such a
victim's twin over the blocked images themselves. ``dtype=torch.bfloat16``
builds a bf16 victim: fp32 parameters, bf16 compute layer by layer as the
JAX package's ``dtype=jnp.bfloat16`` victim (``models.layers``), bf16
logits.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import DeviceLike, resolve_device
from .densenet import densenet121, densenet169
from .fold import fold_batchnorms_, foldable
from .googlenet import googlenet
from .inception import inception_v3
from .layers import (IMAGENET_MEAN, IMAGENET_STD, Normalize, depth_to_space, resolve_dtype,
                     space_to_depth)
from .mobilenet import mobilenet_v2
from .resnet import resnet18, resnet34, resnet50
from .tiny import tiny_cnn
from .vgg import vgg11, vgg16, vgg19
from .vit import SelfAttention, VisionTransformer, vit_b16, vit_tiny

# name -> (constructor, default input size), the JAX package's registry; the
# short aliases are the reference CLI's names ('resnet' means resnet18).
MODEL_REGISTRY: Dict[str, Tuple[Callable[..., nn.Module], int]] = {
    "resnet": (resnet18, 224),
    "resnet18": (resnet18, 224),
    "resnet34": (resnet34, 224),
    "resnet50": (resnet50, 224),
    "densenet": (densenet121, 224),
    "densenet121": (densenet121, 224),
    "densenet169": (densenet169, 224),
    "googlenet": (googlenet, 224),
    "inception": (inception_v3, 299),
    "inception_v3": (inception_v3, 299),
    "mobilenet": (mobilenet_v2, 224),
    "mobilenet_v2": (mobilenet_v2, 224),
    "vgg": (vgg11, 224),
    "vgg11": (vgg11, 224),
    "vgg16": (vgg16, 224),
    "vgg19": (vgg19, 224),
    "vit": (vit_b16, 224),
    "vit_b16": (vit_b16, 224),
    "vit_tiny": (vit_tiny, 224),
    "tiny": (tiny_cnn, 32),
}


def blanket_input_size(name: str, override: Optional[int] = None) -> Optional[int]:
    """The CLI's input size: ``override`` where given, else 224 for every
    ImageNet victim (the reference feeds one Resize(256) + CenterCrop(224)
    transform to all of them, Inception included), else None (the model's
    own size, 32 for the tiny test victim)."""
    if override:
        return override
    entry = MODEL_REGISTRY.get(name.lower())
    if entry is not None and entry[1] >= 224:
        return 224
    return None


def fast_victim_kwargs(name: str) -> dict:
    """Each architecture's exact-math fast knobs, the JAX package's mapping:
    ResNets and GoogLeNet take ``stem_s2d`` and ``fold_bn``, DenseNet
    ``stem_s2d``, Inception and MobileNet ``fold_bn``, the rest nothing.
    ``cli._victim`` builds the stem and folds after the weights load."""
    key = name.lower()
    if "resnet" in key or "googlenet" in key:
        return dict(stem_s2d=True, fold_bn=True)
    if "densenet" in key:
        return dict(stem_s2d=True)
    if "inception" in key or "mobilenet" in key:
        return dict(fold_bn=True)
    return {}


class VictimModel(nn.Module):
    """A frozen classifier over [0, 1] NHWC images.

    ``forward`` permutes the NHWC batch to an NCHW view; on a contiguous
    NHWC tensor that view is already in ``channels_last`` memory format, so
    no copy is made before the first convolution. The input is normalized
    in its own dtype, as the JAX wrapper normalizes it. ``dtype`` is the
    net's compute dtype: an fp32 net takes the normalized input cast to
    fp32 (Flax's fp32 layers promote a bf16 one); a bf16 net takes it as it
    is, each layer casting to bf16 where Flax's does, and returns bf16
    logits, which the attacks cast to fp32 before a loss, as the JAX
    package's do.

    ``blocked_input=True`` makes the victim of the 2x2 space-to-depth
    images ``(N, S/2, S/2, 12)`` (``layers.space_to_depth``) of a net with
    an S2D stem; the normalization tiles over the 12 channels.
    """

    def __init__(self, name: str, net: nn.Module, input_size: int,
                 normalize: bool = True, mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD, blocked_input: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.name = name
        self.net = net
        self.input_size = input_size
        self.num_classes = net.num_classes
        self.mean, self.std = tuple(mean), tuple(std)
        self.blocked_input = blocked_input
        self.dtype = resolve_dtype(dtype)
        self.norm = Normalize(mean, std) if normalize else None

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if self.norm is not None:
            x = self.norm(x)
        if self.dtype == torch.float32:
            x = x.float()
        if self.blocked_input:
            return self.net(x, blocked_input=True)
        return self.net(x)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Hard labels."""
        return torch.argmax(self(x), dim=-1)


def _init_weights(net: nn.Module, generator: torch.Generator, conv_fan: str) -> None:
    """Seeded random weights (no pretrained weights ship with the repo): He
    normal convolutions over ``conv_fan`` ("fan_out" or "fan_in"), BatchNorm
    and LayerNorm at 1 and 0, linear layers N(0, 0.01), ViT's attention
    Xavier-uniform, its class token 0 and its position embedding
    N(0, 0.02)."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, nn.Conv2d):
                nn.init.kaiming_normal_(mod.weight, mode=conv_fan,
                                        nonlinearity="relu", generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                nn.init.normal_(mod.weight, std=0.01, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, SelfAttention):
                nn.init.xavier_uniform_(mod.in_proj_weight, generator=generator)
                mod.in_proj_bias.zero_()
            elif isinstance(mod, VisionTransformer):
                mod.class_token.zero_()
                nn.init.normal_(mod.encoder.pos_embedding, std=0.02, generator=generator)


def create_model(
    name: str,
    num_classes: int = 1000,
    input_size: Optional[int] = None,
    normalize: bool = True,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    seed: int = 0,
    device: DeviceLike = None,
    fold_bn: bool = False,
    stem_s2d: bool = False,
    blocked_input: bool = False,
    dtype: torch.dtype = torch.float32,
    **model_kwargs,
) -> VictimModel:
    """Build a frozen victim by registry name.

    Without ``state_dict`` the weights are random, drawn on ``device`` from
    a generator seeded with ``seed``. ``device`` defaults to CUDA and raises
    where there is none; pass ``device="cpu"`` for a CPU victim.
    ``fold_bn=True`` folds the BatchNorms of a ResNet, GoogLeNet,
    Inception-v3 or MobileNetV2 into its convolutions once its weights are
    set (``models.fold``, which also folds a built victim). VGG and ViT are
    built for their input size; ``model_kwargs`` go to the constructor
    (``hidden`` for VGG, ``transform_input`` for GoogLeNet and Inception).
    ``stem_s2d=True`` builds a ResNet, DenseNet or GoogLeNet with the S2D
    stem (the same parameters); ``blocked_input=True`` builds it as the
    victim of blocked images (see :class:`VictimModel`). Other families
    refuse both with a ``TypeError``, as the JAX package's do.
    ``dtype`` is the compute dtype, ``torch.float32`` or ``torch.bfloat16``:
    the parameters stay fp32 and a bf16 victim computes and returns bf16
    (see :class:`VictimModel`).
    """
    key = name.lower()
    if key not in MODEL_REGISTRY:
        raise ValueError(f"unknown model '{name}'; known: {sorted(MODEL_REGISTRY)}")
    if fold_bn and not foldable(key):
        raise ValueError(f"model '{name}' has no folded form")
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    ctor, default_size = MODEL_REGISTRY[key]
    size = input_size or default_size
    if key == "tiny":
        num_classes, normalize = min(num_classes, 10), False
    if "input_size" in inspect.signature(ctor).parameters:
        model_kwargs["input_size"] = size
    if stem_s2d or blocked_input:
        model_kwargs["stem_s2d"] = True
    with torch.device(dev):
        net = ctor(num_classes=num_classes, dtype=dtype, **model_kwargs)
    if state_dict is None:
        # The ResNets and the tiny CNN keep the fan_out rule they were first
        # drawn with. Under it, with BatchNorm at its identity statistics, a
        # random MobileNetV2's logits vanish (about 1e-9: a depthwise
        # kernel's fan_out counts every group) and a random DenseNet's blow
        # up (1e5 and more: each 1x1 conv reads all the concatenated
        # features), so the other families draw over fan_in, which keeps
        # their activations near unit scale.
        conv_fan = "fan_out" if key.startswith("resnet") or key == "tiny" else "fan_in"
        _init_weights(net, torch.Generator(device=dev).manual_seed(seed), conv_fan)
    else:
        net.load_state_dict(state_dict)
    if fold_bn:
        fold_batchnorms_(net)
    net = net.to(memory_format=torch.channels_last)
    victim = VictimModel(key, net, size, normalize, mean, std, blocked_input, dtype)
    victim.to(dev)
    victim.eval()
    victim.requires_grad_(False)
    return victim


def blocked_twin(victim: VictimModel) -> Optional[VictimModel]:
    """The victim of the space-to-depth images of ``victim``'s images: the
    same net (the same parameters, folded or not) and the same normalization,
    with GoogLeNet's ``transform_input`` kept inside the net; None where the
    victim's net has no S2D stem, as in the JAX package, whose plain stem
    keeps its parameters elsewhere. Memoized on the victim (outside its
    submodules, so that its ``state_dict`` does not change). The twin keeps
    the victim's dtype."""
    if victim.blocked_input:
        return victim
    if not getattr(victim.net, "stem_s2d", False):
        return None
    twin = victim.__dict__.get("_blocked_twin")
    if twin is None:
        twin = VictimModel(victim.name, victim.net, victim.input_size,
                           victim.norm is not None, victim.mean, victim.std,
                           blocked_input=True, dtype=victim.dtype)
        twin.to(victim.device)
        twin.eval()
        twin.requires_grad_(False)
        victim.__dict__["_blocked_twin"] = twin
    return twin


__all__ = ["MODEL_REGISTRY", "Normalize", "VictimModel", "blanket_input_size", "blocked_twin",
           "create_model", "densenet121", "densenet169", "depth_to_space", "fast_victim_kwargs",
           "googlenet", "inception_v3", "mobilenet_v2", "resnet18", "resnet34", "resnet50",
           "space_to_depth", "tiny_cnn", "vgg11", "vgg16", "vgg19", "vit_b16", "vit_tiny"]
