"""Attack-quality metrics and top-1 accuracy.

Port of ``compute_fooling_rate``, ``compute_rmse``, ``compute_mse``,
``model_accuracy`` and ``model_accuracy_sharded`` from
``dl_attack_on_imagenet_tpu/evaluation/metrics.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

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


@torch.no_grad()
def model_accuracy_sharded(dataset, victim: VictimModel, mesh, batch_size: int = 128,
                           axis: str = "data") -> float:
    """Top-1 accuracy with each global batch of ``batch_size`` rows a rank
    sharded over ``mesh``: each rank takes its slice of the batch,
    zero-padded to the slice's size, counts the correct real rows, and
    the counts are all-reduced once at the end (the reference's
    DistributedSampler and ``dist.reduce(SUM)``). Every rank gets the same
    number."""
    ds = as_array_dataset(dataset)
    group = mesh.get_group(axis)
    n_dev, rank = mesh.size(), dist.get_rank(group)
    dev = victim.device
    images, labels = ds.as_arrays()
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    step = batch_size * n_dev
    for start in range(0, len(ds), step):
        x = np.asarray(images[start:start + step], np.float32)
        local = -(-x.shape[0] // n_dev)
        rows = slice(rank * local, (rank + 1) * local)
        x, y = x[rows], np.asarray(labels[start:start + step])[rows]
        real = len(y)
        if real < local:  # this rank's slice runs past the batch: pad it
            x = np.concatenate([x, np.zeros((local - real,) + x.shape[1:], np.float32)])
            y = np.concatenate([y, np.zeros((local - real,), y.dtype)])
        hit = victim.predict(torch.as_tensor(x, device=dev)) == torch.as_tensor(y, device=dev)
        correct += torch.sum(hit[:real])
    dist.all_reduce(correct, group=group)
    return int(correct) / len(ds)
