"""ADIL — Adversarial Dictionary Learning attack, serving half.

Port of the inference half of ``dl_attack_on_imagenet_tpu/attacks/adil.py``:
the constructor, the memoized dictionary artifact, ``forward`` (supervised
DDrague or unsupervised best-of-trials sampling) and
``forward_supervised_adamw``. Dictionary learning is not ported yet: where
the JAX class would learn a dictionary, this one raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import VictimModel
from ..utils import ArtifactCache
from . import adil_core as core
from .adil_core import AdilConfig
from .base import Attack

_TRAINING_NOT_PORTED = (
    "dictionary learning is not ported yet (it comes with the training "
    "slice of the port); save a trained dictionary to the artifact cache "
    "first, e.g. with the JAX package")


class ADIL(Attack):
    """Adversarial Dictionary Learning (ADiL), serving a frozen dictionary.

    Unseen images are attacked by optimizing fresh codes (``attack=
    "supervised"``, DDrague) or by sampling them (``"unsupervised"``).
    """

    def __init__(
        self,
        victim: VictimModel,
        eps: float = 8 / 255,
        steps: int = 500,
        norm: str = "linf",
        targeted: bool = False,
        n_atoms: int = 100,
        batch_size: int = 100,
        data_train=None,
        data_val=None,
        trials: int = 10,
        attack: str = "supervised",
        model_name: Optional[str] = None,
        step_size: float = 0.01,
        steps_in: int = 1,
        loss: str = "ce",
        kappa: float = 50.0,
        steps_inference: int = 30,
        cache: Optional[ArtifactCache] = None,
        seed: int = 0,
    ):
        super().__init__(victim, "ADIL", targeted)
        self.cfg = AdilConfig(
            eps=eps,
            norm=norm.lower(),
            n_atoms=n_atoms,
            loss=loss,
            kappa=kappa,
            targeted=targeted,
            step_size=step_size,
            steps=int(steps),
            steps_inner=steps_in or 1,
            batch_size=batch_size,
            trials=int(trials),
            steps_inference=int(steps_inference),
        )
        self.attack_mode = attack
        self.model_name = model_name or victim.name
        self.cache = cache or ArtifactCache("trained_dicts")
        self.seed = seed
        self.dictionary: Optional[torch.Tensor] = None
        self._rng_calls = 0  # per-call seed offset so equal batches differ

        # Artifact memoization: the JAX class trains when the artifact is
        # missing and training data is given.
        if data_train is not None and not self.cache.exists("ImageNet", model=self.model_name):
            raise NotImplementedError(_TRAINING_NOT_PORTED)

    @property
    def is_trained(self) -> bool:
        """Whether a dictionary is loaded or memoized."""
        return self.dictionary is not None or self.cache.exists(
            "ImageNet", model=self.model_name)

    def _load_dictionary(self) -> torch.Tensor:
        if self.dictionary is not None:
            return self.dictionary
        payload = self.cache.load("ImageNet", model=self.model_name)
        if payload is None:
            raise FileNotFoundError(
                f"no trained dictionary at "
                f"{self.cache.path('ImageNet', model=self.model_name)}")
        self.dictionary = torch.as_tensor(
            payload["d"], dtype=torch.float32, device=self.victim.device).contiguous()
        return self.dictionary

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images, dtype=torch.float32,
                               device=self.victim.device).contiguous()

    def forward(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Attack a batch with the memoized dictionary, by ``attack`` mode."""
        if not self.is_trained:
            raise NotImplementedError(_TRAINING_NOT_PORTED)
        d = self._load_dictionary()
        images = self._images(images)
        if self.attack_mode == "supervised":
            return core.supervised_ddrague(self.victim, d, images, self.cfg)
        self._rng_calls += 1
        generator = torch.Generator(device=images.device)
        generator.manual_seed(self.seed * 1_000_003 + self._rng_calls)
        return core.unsupervised_sample(self.victim, d, images, generator, self.cfg)

    def forward_supervised_adamw(self, images: torch.Tensor) -> torch.Tensor:
        """The alternative supervised solver: AdamW on the codes."""
        d = self._load_dictionary()
        return core.supervised_adamw_codes(self.victim, d, self._images(images), self.cfg)
