"""Victim models: torch classifiers behind a frozen NHWC wrapper.

Port of ``dl_attack_on_imagenet_tpu/models/__init__.py`` for the ResNets and
the tiny test CNN. A name picks a classifier, the ImageNet normalization is
prepended, and the result is a frozen function from [0, 1] NHWC images to
logits: eval mode, no weight gradients, weights in ``channels_last``. The
other victims of the JAX package wait for ROADMAP.md queue 1 item 7.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import DeviceLike, resolve_device
from .fold import fold_batchnorms_
from .layers import IMAGENET_MEAN, IMAGENET_STD, Normalize
from .resnet import resnet18, resnet34, resnet50
from .tiny import tiny_cnn

# name -> (constructor, default input size); 'resnet' means resnet18, as in
# the reference CLI.
MODEL_REGISTRY: Dict[str, Tuple[Callable[..., nn.Module], int]] = {
    "resnet": (resnet18, 224),
    "resnet18": (resnet18, 224),
    "resnet34": (resnet34, 224),
    "resnet50": (resnet50, 224),
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
    The port builds ``fold_bn``; ``stem_s2d`` is a TPU layout of the same
    stem (ROADMAP.md queue 1 item 12) that ``cli._victim`` drops with a
    printed line."""
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
    no copy is made before the first convolution.
    """

    def __init__(self, name: str, net: nn.Module, input_size: int,
                 normalize: bool = True, mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD):
        super().__init__()
        self.name = name
        self.net = net
        self.input_size = input_size
        self.num_classes = net.num_classes
        self.norm = Normalize(mean, std) if normalize else None

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if self.norm is not None:
            x = self.norm(x)
        return self.net(x)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Hard labels."""
        return torch.argmax(self(x), dim=-1)


def _init_weights(net: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights (no pretrained weights ship with the repo)."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, nn.Conv2d):
                nn.init.kaiming_normal_(mod.weight, mode="fan_out",
                                        nonlinearity="relu", generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                nn.init.normal_(mod.weight, std=0.01, generator=generator)
                mod.bias.zero_()


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
) -> VictimModel:
    """Build a frozen victim by registry name.

    Without ``state_dict`` the weights are random, drawn on ``device`` from
    a generator seeded with ``seed``. ``device`` defaults to CUDA and raises
    where there is none; pass ``device="cpu"`` for a CPU victim.
    ``fold_bn=True`` folds a ResNet's BatchNorms into its convolutions once
    its weights are set (``models.fold``, which also folds a built victim).
    """
    key = name.lower()
    if key not in MODEL_REGISTRY:
        raise ValueError(f"model '{name}' is not ported yet (ROADMAP.md queue 1 item 7); "
                         f"ported: {sorted(MODEL_REGISTRY)}")
    if fold_bn and "resnet" not in key:
        raise ValueError(f"model '{name}' has no folded form in the port")
    dev = resolve_device(device)
    ctor, default_size = MODEL_REGISTRY[key]
    if key == "tiny":
        num_classes, normalize = min(num_classes, 10), False
    with torch.device(dev):
        net = ctor(num_classes=num_classes)
    if state_dict is None:
        _init_weights(net, torch.Generator(device=dev).manual_seed(seed))
    else:
        net.load_state_dict(state_dict)
    if fold_bn:
        fold_batchnorms_(net)
    net = net.to(memory_format=torch.channels_last)
    victim = VictimModel(key, net, input_size or default_size, normalize, mean, std)
    victim.to(dev)
    victim.eval()
    victim.requires_grad_(False)
    return victim


__all__ = ["MODEL_REGISTRY", "Normalize", "VictimModel", "blanket_input_size", "create_model",
           "fast_victim_kwargs", "resnet18", "resnet34", "resnet50", "tiny_cnn"]
