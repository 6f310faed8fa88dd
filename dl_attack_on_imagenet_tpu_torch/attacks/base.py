"""Attack base class: frozen-victim plumbing shared by all attacks.

Port of ``dl_attack_on_imagenet_tpu/attacks/base.py``: a callable
``attack(images, labels) -> adv_images`` over NHWC [0, 1] tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import VictimModel


class Attack:
    """Base for attacks on a frozen victim classifier."""

    def __init__(self, victim: VictimModel, name: str = "Attack", targeted: bool = False):
        self.victim = victim
        self.name = name
        self.targeted = targeted

    @torch.no_grad()
    def get_target(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Targeted => second most probable class, else the given labels."""
        if not self.targeted:
            return labels
        return torch.argsort(self.victim(images), dim=-1)[:, -2]

    @torch.no_grad()
    def predict(self, images: torch.Tensor) -> torch.Tensor:
        return self.victim.predict(images)

    def forward(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, images, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        images = torch.as_tensor(images, dtype=torch.float32, device=self.victim.device)
        if labels is None:
            labels = self.predict(images)
        return self.forward(images, torch.as_tensor(labels, device=images.device))
