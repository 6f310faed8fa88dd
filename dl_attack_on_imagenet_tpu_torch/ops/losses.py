"""Attack losses: CW margin ('logits') and cross-entropy, targeted/untargeted,
and the DLR losses of APGD.

Port of ``dl_attack_on_imagenet_tpu/ops/losses.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cw_margin_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    kappa: float = 50.0,
    targeted: bool = False,
) -> torch.Tensor:
    """Carlini-Wagner margin loss, per sample.

    Untargeted: ``clamp(logit[label] - runner_up, min=-kappa)``; targeted:
    ``clamp(runner_up - logit[t], min=-kappa)``. The runner-up is
    ``max((1 - one_hot) * logits)``, which leaves a literal 0 in the
    true-class slot, so it is floored at zero when every other logit is
    negative. ``amax`` splits the gradient among tied maxima as JAX's
    ``max`` does.
    """
    one_hot = F.one_hot(labels, logits.shape[-1]).to(logits.dtype)
    true_logit = torch.sum(logits * one_hot, dim=-1)
    runner_up = torch.amax((1.0 - one_hot) * logits, dim=-1)
    if targeted:
        margin = runner_up - true_logit
    else:
        margin = true_logit - runner_up
    return torch.clamp(margin, min=-kappa)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None])[:, 0]


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sum-reduced softmax cross entropy."""
    return torch.sum(_nll(logits, labels))


def cross_entropy_mean(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean-reduced softmax cross entropy."""
    return torch.mean(_nll(logits, labels))


def true_and_runner_up(logits: torch.Tensor, labels: torch.Tensor):
    """Per sample, the label's logit and the largest other logit (``amax``
    splits the gradient among tied maxima, as JAX's ``max`` does)."""
    true_logit = logits.gather(1, labels[:, None])[:, 0]
    hot = F.one_hot(labels, logits.shape[-1]) > 0
    return true_logit, torch.amax(torch.where(hot, -torch.inf, logits), dim=-1)


def dlr_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Difference-of-Logits-Ratio loss, per sample (Croce & Hein 2020,
    eq. 6), maximized by APGD-DLR: ``-(z_y - max_{i != y} z_i) / (z_pi1 -
    z_pi3 + 1e-12)`` with pi sorting the logits descending. The sort is
    stable, as JAX's, so a tie sends the gradient to the same logit."""
    true_logit, other = true_and_runner_up(logits, labels)
    sorted_z = torch.sort(logits, dim=-1, stable=True).values  # ascending
    z1, z3 = sorted_z[:, -1], sorted_z[:, -3]
    return -(true_logit - other) / (z1 - z3 + 1e-12)


def dlr_loss_targeted(logits: torch.Tensor, labels: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Targeted DLR, per sample (eq. 7, APGD-T), maximized:
    ``-(z_y - z_t) / (z_pi1 - (z_pi3 + z_pi4) / 2 + 1e-12)``."""
    true_logit = logits.gather(1, labels[:, None])[:, 0]
    target_logit = logits.gather(1, targets[:, None])[:, 0]
    sorted_z = torch.sort(logits, dim=-1, stable=True).values
    z1, z3, z4 = sorted_z[:, -1], sorted_z[:, -3], sorted_z[:, -4]
    return -(true_logit - target_logit) / (z1 - 0.5 * (z3 + z4) + 1e-12)


def attack_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    loss: str = "ce",
    targeted: bool = False,
    kappa: float = 50.0,
    reduction: str = "sum",
) -> torch.Tensor:
    """'ce': ``coeff * CE`` with coeff +1 targeted / -1 untargeted;
    'logits': the CW margin, whose sign is handled inside the margin."""
    if loss == "ce":
        coeff = 1.0 if targeted else -1.0
        if reduction == "mean":
            return coeff * cross_entropy_mean(logits, labels)
        return coeff * cross_entropy_sum(logits, labels)
    if loss == "logits":
        margins = cw_margin_loss(logits, labels, kappa=kappa, targeted=targeted)
        if reduction == "mean":
            return torch.mean(margins)
        return torch.sum(margins)
    raise ValueError(f"unknown loss: {loss}")
