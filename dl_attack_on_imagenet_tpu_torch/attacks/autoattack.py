"""AutoAttack: the parameter-free ensemble of APGD-CE, APGD-T, FAB-T and
Square.

Port of ``dl_attack_on_imagenet_tpu/attacks/autoattack.py`` (Croce & Hein,
ICML 2020), built from this package's own members:

- 'standard': APGD-CE, APGD-T (targeted DLR, 9 target classes), FAB-T and
  Square, the published standard suite;
- 'rand': APGD-CE and APGD-DLR with EOT over 20 gradients, the variant for
  randomized defenses.

An image the victim already misclassifies keeps its clean input; each
member contributes adversaries only for images no earlier member fooled
inside the budget (``l∞ <= eps + 1e-6``, since FAB minimizes distortion
and may land outside it). Every member runs on the full batch and the
ensemble merges by mask, as the JAX package does; the cascade stops once no
image is robust, one host read a member.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import VictimModel
from .apgd import APGD, APGDT
from .base import Attack
from .fab import FAB
from .square import Square


class AutoAttack(Attack):
    def __init__(self, victim: VictimModel, norm: str = "Linf", eps: float = 8 / 255,
                 version: str = "standard", n_classes: int = 10, seed: int = 0,
                 steps: int = 100, n_queries: int = 5000, attacks_to_run=None):
        super().__init__(victim, "AutoAttack", False)
        if norm.lower() != "linf":
            raise ValueError("AutoAttack: only norm='Linf' is implemented")
        self.eps, self.version, self.seed = eps, version, seed
        # The published suite uses 9 target classes whatever the label
        # space; n_classes only caps it for a small one.
        n_target = min(9, max(n_classes - 1, 1)) + 1
        if attacks_to_run is None:
            if version == "standard":
                attacks_to_run = ("apgd-ce", "apgd-t", "fab-t", "square")
            elif version == "rand":
                attacks_to_run = ("apgd-ce-rand", "apgd-dlr-rand")
            else:
                raise ValueError(f"unknown AutoAttack version: {version}")
        self.attacks_to_run = tuple(attacks_to_run)
        builders = {
            "apgd-ce": lambda: APGD(victim, eps=eps, steps=steps, loss="ce", seed=seed),
            "apgd-dlr": lambda: APGD(victim, eps=eps, steps=steps, loss="dlr", seed=seed),
            "apgd-t": lambda: APGDT(victim, eps=eps, steps=steps, n_classes=n_target, seed=seed),
            "fab-t": lambda: FAB(victim, eps=eps, steps=steps, n_classes=n_target,
                                 targeted=True, seed=seed),
            "square": lambda: Square(victim, eps=eps, n_queries=n_queries, loss="margin",
                                     seed=seed),
            "apgd-ce-rand": lambda: APGD(victim, eps=eps, steps=steps, loss="ce", eot_iter=20,
                                         seed=seed),
            "apgd-dlr-rand": lambda: APGD(victim, eps=eps, steps=steps, loss="dlr",
                                          eot_iter=20, seed=seed),
        }
        self._attacks = [(name, builders[name]()) for name in self.attacks_to_run]

    def forward(self, images, labels, draws: Optional[dict] = None,
                stats: Optional[dict] = None):
        """``draws`` maps a member's name to the draws its ``forward``
        takes. With ``stats``, ``stats["robust"]`` gets the robust mask
        after each member that ran (host arrays)."""
        with torch.no_grad():
            robust = self.victim.predict(images) == labels  # misclassified: keep clean
        adv_out = images
        for name, atk in self._attacks:
            if not bool(robust.any()):
                break
            kwargs = {} if draws is None or name not in draws else {"draws": draws[name]}
            cand = atk(images, labels, **kwargs)
            dist = torch.amax(torch.abs(cand - images), dim=(1, 2, 3))
            with torch.no_grad():
                fooled = (self.victim.predict(cand) != labels) & (dist <= self.eps + 1e-6)
            take = robust & fooled
            adv_out = torch.where(take[:, None, None, None], cand, adv_out)
            robust = robust & ~fooled
            if stats is not None:
                stats.setdefault("robust", []).append(robust.cpu().numpy())
        return adv_out
