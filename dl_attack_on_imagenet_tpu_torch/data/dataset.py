"""In-memory dataset container used by the attack layer.

Port of ``dl_attack_on_imagenet_tpu/data/dataset.py``, numpy only: every
batch carries its global row indices, which the per-image code matrix ``v``
needs. A shuffled epoch draws its order from ``np.random.default_rng(seed)``
as the JAX package does, so both packages stream batches in one order.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    """Images (N, H, W, C) float32 in [0, 1] and integer labels (N,)."""

    images: np.ndarray
    labels: np.ndarray

    def __post_init__(self):
        self.images = np.asarray(self.images)
        self.labels = np.asarray(self.labels)
        if self.images.shape[0] != self.labels.shape[0]:
            raise ValueError(f"{self.images.shape[0]} images but "
                             f"{self.labels.shape[0]} labels")

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, i):
        return self.images[i], self.labels[i]

    @property
    def image_shape(self) -> Tuple[int, ...]:
        return tuple(self.images.shape[1:])

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.images, self.labels

    def subset(self, indices) -> "ArrayDataset":
        idx = np.asarray(indices)
        return ArrayDataset(self.images[idx], self.labels[idx])

    def batches(
        self, batch_size: int, shuffle: bool = False, seed: int = 0,
        drop_remainder: bool = False,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (indices, images, labels) host batches."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        stop = n - n % batch_size if drop_remainder else n
        for start in range(0, stop, batch_size):
            idx = order[start : start + batch_size]
            yield idx, self.images[idx], self.labels[idx]


def as_array_dataset(data) -> ArrayDataset:
    """Coerce (images, labels) tuples or dataset-likes to ArrayDataset."""
    if isinstance(data, ArrayDataset):
        return data
    if isinstance(data, (tuple, list)) and len(data) == 2:
        return ArrayDataset(np.asarray(data[0]), np.asarray(data[1]))
    if hasattr(data, "images") and hasattr(data, "labels"):
        return ArrayDataset(np.asarray(data.images), np.asarray(data.labels))
    raise TypeError(f"cannot interpret {type(data)} as a dataset")
