"""Class-balanced dataset splitting.

Port of ``dl_attack_on_imagenet_tpu/data/splits.py``, numpy only: the same
``np.random.default_rng(seed)`` shuffles the rows of each class in the same
order, so both packages pick the same indices.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .dataset import ArrayDataset


def split_by_class(
    dataset: ArrayDataset,
    number_per_class: Sequence[int],
    number_of_classes: int = 1000,
    seed: int = 0,
) -> Tuple[ArrayDataset, ...]:
    """Split into ``len(number_per_class)`` class-balanced subsets.

    ``number_per_class = [n_train, n_val, n_test]`` takes, for each of the
    first ``number_of_classes`` classes in sorted label order, that many
    shuffled samples for each split. Raises where a class has fewer samples
    than the splits need together.
    """
    labels = np.asarray(dataset.labels)
    classes = np.unique(labels)[:number_of_classes]
    need = int(sum(number_per_class))
    rng = np.random.default_rng(seed)

    split_indices = [[] for _ in number_per_class]
    for c in classes:
        rows = np.where(labels == c)[0]
        if len(rows) < need:
            raise ValueError(f"class {c} has {len(rows)} samples, need {need} for splits "
                             f"{list(number_per_class)}")
        rng.shuffle(rows)
        offset = 0
        for slot, count in enumerate(number_per_class):
            split_indices[slot].append(rows[offset:offset + count])
            offset += count

    return tuple(dataset.subset(np.concatenate(idxs)) for idxs in split_indices)
