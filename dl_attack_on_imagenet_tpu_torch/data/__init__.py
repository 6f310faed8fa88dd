"""Host datasets and the host-to-device input pipeline."""

from .dataset import ArrayDataset, as_array_dataset
from .pipeline import prefetch_to_device

__all__ = ["ArrayDataset", "as_array_dataset", "prefetch_to_device"]
