"""Attack losses: CW margin ('logits') and cross-entropy, targeted/untargeted.

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
