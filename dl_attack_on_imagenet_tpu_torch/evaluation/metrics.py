"""Attack-quality metrics: fooling rate, relative MSE and MSE.

Port of ``compute_fooling_rate``, ``compute_rmse`` and ``compute_mse`` from
``dl_attack_on_imagenet_tpu/evaluation/metrics.py``.
"""

from __future__ import annotations

import torch

from ..models import VictimModel


def _reduce(x: torch.Tensor, reduction: str) -> float:
    return float(torch.sum(x) if reduction == "sum" else torch.mean(x))


def _per_image_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=tuple(range(1, x.dim())))


@torch.no_grad()
def compute_fooling_rate(victim: VictimModel, adversary, clean, reduction="sum",
                         clean_labels=None) -> float:
    """Label-change fooling criterion; pass ``clean_labels`` when the clean
    predictions are already known to skip one forward."""
    dev = victim.device
    if clean_labels is None:
        clean_labels = victim.predict(torch.as_tensor(clean, device=dev))
    label_adv = victim.predict(torch.as_tensor(adversary, device=dev))
    diff = (torch.as_tensor(clean_labels, device=dev) != label_adv).float()
    return _reduce(diff, reduction)


def compute_rmse(adversary, clean, reduction="sum") -> float:
    """Relative MSE: ||delta||^2 / ||x||^2 per image."""
    adversary, clean = torch.as_tensor(adversary), torch.as_tensor(clean)
    ratio = _per_image_sum((adversary - clean) ** 2) / _per_image_sum(clean ** 2)
    return _reduce(ratio, reduction)


def compute_mse(adversary, clean, reduction="sum") -> float:
    """Per-image squared error."""
    adversary, clean = torch.as_tensor(adversary), torch.as_tensor(clean)
    return _reduce(_per_image_sum((adversary - clean) ** 2), reduction)
