"""Per-image gradient attacks: FGSM, BIM, PGD (l∞ / l2).

Port of ``dl_attack_on_imagenet_tpu/attacks/pgd.py``. Each step is one
forward and one backward of the victim on the whole batch, in the input's
dtype; the CE loss is taken on fp32 logits, as the JAX package casts them.
The random start is a draw the caller may pass in (``delta0``); the classes
draw it from their seeded host generator.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import VictimModel
from ..ops import clamp_image, cross_entropy_mean
from .base import Attack, Seeded


def _l2_per_image(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(t ** 2, dim=(1, 2, 3), keepdim=True))


def ce_grad(model, x: torch.Tensor, labels: torch.Tensor, targeted: bool) -> torch.Tensor:
    """The input gradient of the mean CE of ``model``'s fp32 logits at
    ``x``, negated where ``targeted`` (the attacks ascend it)."""
    coeff = -1.0 if targeted else 1.0
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = coeff * cross_entropy_mean(model(x).float(), labels)
        return torch.autograd.grad(loss, x)[0]


def linf_start(generator: torch.Generator, shape, eps: float) -> torch.Tensor:
    """A uniform draw in [-eps, eps] on the host, the l∞ random start."""
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * eps


def l2_start(generator: torch.Generator, shape, eps: float) -> torch.Tensor:
    """A Gaussian direction scaled to l2 norm eps per image, the l2 start."""
    d = torch.randn(shape, generator=generator)
    return d / torch.clamp(_l2_per_image(d), min=1e-12) * eps


def fgsm(model, images, labels, eps, targeted=False):
    """One signed-gradient step (Goodfellow et al.)."""
    g = ce_grad(model, images, labels, targeted)
    return clamp_image(images + eps * torch.sign(g))


def pgd(model, images, labels, eps, alpha, steps: int, norm: str = "linf",
        random_start: bool = True, targeted: bool = False,
        delta0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Projected gradient descent in the eps-ball around the clean images.

    norm='linf': signed-gradient steps, elementwise clamp to ±eps.
    norm='l2':   normalized-gradient steps, l2-ball projection.
    ``delta0`` is the random start (required where ``random_start``);
    random_start=False reproduces BIM (iterative FGSM).
    """
    if random_start:
        if delta0 is None:
            raise ValueError("pgd with random_start needs its start draw delta0")
        adv = clamp_image(images + delta0.to(images))
    else:
        adv = clamp_image(images)
    for _ in range(steps):
        g = ce_grad(model, adv, labels, targeted)
        if norm == "linf":
            adv = adv + alpha * torch.sign(g)
            delta = torch.clamp(adv - images, -eps, eps)
        else:
            adv = adv + alpha * g / torch.clamp(_l2_per_image(g), min=1e-12)
            delta = adv - images
            delta = delta * torch.clamp(eps / torch.clamp(_l2_per_image(delta), min=1e-12),
                                        max=1.0)
        adv = clamp_image(images + delta)
    return adv


class FGSM(Attack):
    def __init__(self, victim: VictimModel, eps: float = 8 / 255, targeted: bool = False):
        super().__init__(victim, "FGSM", targeted)
        self.eps = eps

    def forward(self, images, labels):
        labels = self.get_target(images, labels)
        return fgsm(self.victim, images, labels, self.eps, self.targeted)


class PGD(Seeded):
    def __init__(self, victim: VictimModel, eps: float = 8 / 255, alpha: float = 2 / 255,
                 steps: int = 10, norm: str = "linf", random_start: bool = True,
                 targeted: bool = False, seed: int = 0):
        super().__init__(victim, "PGD", targeted, seed)
        self.eps, self.alpha, self.steps = eps, alpha, steps
        self.norm = norm.lower()
        self.random_start = random_start

    def draws(self, shape) -> Optional[torch.Tensor]:
        """This call's random start, None without one."""
        if not self.random_start:
            return None
        start = linf_start if self.norm == "linf" else l2_start
        return start(self._generator(), shape, self.eps)

    def forward(self, images, labels, draws=None):
        labels = self.get_target(images, labels)
        self._rng_calls += 1
        if draws is None:
            draws = self.draws(images.shape)
        return pgd(self.victim, images, labels, self.eps, self.alpha, self.steps,
                   norm=self.norm, random_start=self.random_start, targeted=self.targeted,
                   delta0=draws)


class BIM(PGD):
    """Iterative FGSM = PGD without the random start."""

    def __init__(self, victim, eps=8 / 255, alpha=2 / 255, steps=10, targeted=False):
        super().__init__(victim, eps, alpha, steps, "linf", False, targeted)
        self.name = "BIM"
