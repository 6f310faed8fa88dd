"""Carlini-Wagner l2 attack.

Port of ``dl_attack_on_imagenet_tpu/attacks/cw.py``: Adam in tanh space,
``adv = (tanh(w) + 1) / 2``, on ``sum ||adv - x||² + c · sum f(adv)`` with
the paper's f6 margin on the exact logits (not the zero-floored margin of
``ops.cw_margin_loss``), keeping each image's lowest-l2 iterate that fools
the victim, or the clean image where none does. The full step budget runs.

The Adam update is written out as the JAX package writes it: its step
count ``t`` is the loop index, and it runs in float32 whatever the input.
"""

from __future__ import annotations

import torch

from ..models import VictimModel
from ..ops.losses import true_and_runner_up
from .base import Attack

_ATANH_CLIP = 1.0 - 1e-6  # atanh(±1) = ±inf; images at exact 0/1 need room


def _f_margin(logits, labels, kappa, targeted):
    """``max(z_y - max_{c != y} z_c, -kappa)`` untargeted; targeted (labels
    the targets) ``max(max_{c != t} z_c - z_t, -kappa)``."""
    true_logit, other = true_and_runner_up(logits, labels)
    margin = other - true_logit if targeted else true_logit - other
    return torch.clamp(margin, min=-kappa)


def cw_l2(model, images, labels, c, kappa, lr, steps: int, targeted=False):
    """CW-l2. Returns the per-image best (lowest-l2 fooling) iterate, or
    the clean image where no iterate fooled the victim."""
    x32 = images.float()
    w = torch.atanh(torch.clamp(2.0 * x32 - 1.0, -_ATANH_CLIP, _ATANH_CLIP))
    n = images.shape[0]
    b1, b2, eps_adam = 0.9, 0.999, 1e-8

    def evaluate(w, with_grad=True):
        """(gradient of the cost at w or None, adversary, its l2, its logits)."""
        w = w.detach().requires_grad_(with_grad)
        with torch.set_grad_enabled(with_grad):
            adv = 0.5 * (torch.tanh(w) + 1.0)
            l2 = torch.sum((adv - x32) ** 2, dim=(1, 2, 3))
            logits = model(adv).float()
            if not with_grad:
                return None, adv, l2, logits
            cost = torch.sum(l2) + c * torch.sum(_f_margin(logits, labels, kappa, targeted))
            g = torch.autograd.grad(cost, w)[0]
        return g, adv.detach(), l2.detach(), logits.detach()

    def fold(best_adv, best_l2, adv, l2, logits):
        pred = torch.argmax(logits, dim=-1)
        success = (pred == labels) if targeted else (pred != labels)
        take = success & (l2 < best_l2)
        return (torch.where(take[:, None, None, None], adv, best_adv),
                torch.where(take, l2, best_l2))

    m, v = torch.zeros_like(w), torch.zeros_like(w)
    best_adv, best_l2 = x32, torch.full((n,), torch.inf, device=images.device)
    for i in range(steps):
        g, adv, l2, logits = evaluate(w)
        best_adv, best_l2 = fold(best_adv, best_l2, adv, l2, logits)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        # The bias corrections in float32, as JAX takes them.
        t = torch.tensor(i + 1, dtype=torch.float32)
        mhat = m / float(1.0 - torch.tensor(b1) ** t)
        vhat = v / float(1.0 - torch.tensor(b2) ** t)
        w = w - lr * mhat / (torch.sqrt(vhat) + eps_adam)
    # The loop evaluates the iterate before each step; fold in the last too.
    _, adv, l2, logits = evaluate(w, with_grad=False)
    best_adv, _ = fold(best_adv, best_l2, adv, l2, logits)
    return best_adv.to(images.dtype)


class CW(Attack):
    def __init__(self, victim: VictimModel, c: float = 1.0, kappa: float = 0.0,
                 steps: int = 50, lr: float = 0.01, targeted: bool = False):
        super().__init__(victim, "CW", targeted)
        self.c, self.kappa, self.steps, self.lr = c, kappa, steps, lr

    def forward(self, images, labels):
        labels = self.get_target(images, labels)
        return cw_l2(self.victim, images, labels, self.c, self.kappa, self.lr, self.steps,
                     self.targeted)
