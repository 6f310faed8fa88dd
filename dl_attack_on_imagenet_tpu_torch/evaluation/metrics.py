"""Attack-quality metrics and top-1 accuracy.

Port of ``compute_fooling_rate``, ``compute_rmse``, ``compute_mse`` and
``model_accuracy`` from ``dl_attack_on_imagenet_tpu/evaluation/metrics.py``.
``model_accuracy_sharded`` waits for the data-parallel port (ROADMAP.md
queue 1 item 6).
"""

from __future__ import annotations

import torch

from ..data import as_array_dataset
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


@torch.no_grad()
def model_accuracy(dataset, victim: VictimModel, batch_size: int = 128) -> float:
    """Top-1 accuracy over a dataset: one forward a batch on the victim's
    device, the correct count summed there and read once at the end."""
    ds = as_array_dataset(dataset)
    dev = victim.device
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    for _, x, y in ds.batches(batch_size):
        pred = victim.predict(torch.as_tensor(x, dtype=torch.float32, device=dev))
        correct += torch.sum(pred == torch.as_tensor(y, device=dev))
    return int(correct) / len(ds)
