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
        return torch.argsort(self.victim(images), dim=-1, stable=True)[:, -2]

    @torch.no_grad()
    def predict(self, images: torch.Tensor) -> torch.Tensor:
        return self.victim.predict(images)

    def forward(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, images, labels: Optional[torch.Tensor] = None, **kwargs) -> torch.Tensor:
        """``kwargs`` go to ``forward``: the seeded attacks take their random
        draws there (``draws=``) in place of their own."""
        images = torch.as_tensor(images, dtype=torch.float32, device=self.victim.device)
        if labels is None:
            labels = self.predict(images)
        return self.forward(images, torch.as_tensor(labels, device=images.device), **kwargs)


class Seeded(Attack):
    """An attack that draws: a per-instance call counter, as the JAX
    package's classes fold it into ``PRNGKey(seed)``, so calling one
    instance twice on the same inputs draws anew. Draws come from a host
    ``torch.Generator`` seeded from ``(seed, call, run)`` and are moved to
    the device afterwards, so the card and the CPU see the same ones."""

    def __init__(self, victim: VictimModel, name: str, targeted: bool = False, seed: int = 0):
        super().__init__(victim, name, targeted)
        self.seed = seed
        self._rng_calls = 0

    def _generator(self, run: int = 0) -> torch.Generator:
        """The host generator of this call's ``run``-th run (restart or
        target rank)."""
        return torch.Generator().manual_seed(
            (self.seed * 1_000_003 + self._rng_calls) * 1_000_033 + run)
