"""The system under test, as the benchmark drives it: the victim built by
the port's ``create_model`` with the run's weights, and the port's ``ADIL``
with its artifact cache, and the port's ``adil_core``, in which
``faults`` plants its faults. The only module here that imports the port."""

from __future__ import annotations

import torch

from dl_attack_on_imagenet_tpu_torch.attacks import ADIL, adil_core
from dl_attack_on_imagenet_tpu_torch.models import create_model
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

PREFIX = "ImageNet"  # the artifact key ``ADIL`` saves and loads under

__all__ = ["ADIL", "ArtifactCache", "PREFIX", "adil", "adil_core", "victim"]


def victim(config: dict, params: dict, device):
    """The port's frozen victim of the configuration, with ``params``
    (torchvision names) loaded strictly; BatchNorm's step counters, which
    no forward reads, are the only tensors added."""
    state = dict(params)
    for name in params:
        if name.endswith(".running_var"):
            state[name[:-len("running_var")] + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
    return create_model(config["program_model"], num_classes=config["num_classes"],
                        input_size=config["input_size"], state_dict=state, device=device)


def adil(victim_model, config: dict, mix: dict, cache, seed: int, **kwargs):
    """An ``ADIL`` over ``victim_model`` with the configuration's attack
    settings and the mix's job settings; ``kwargs`` adds the rest."""
    att = config["attack"]
    return ADIL(victim_model, eps=att["eps"], norm=att["norm"], n_atoms=att["n_atoms"],
                loss=att["loss"], kappa=att["kappa"], step_size=att["step_size"],
                batch_size=mix["batch"], cache=cache, seed=seed,
                model_name=config["name"], **kwargs)
