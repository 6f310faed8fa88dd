"""Host datasets, the ImageNet folder reader, class-balanced splits and the
host-to-device input pipeline."""

from .dataset import ArrayDataset, as_array_dataset
from .imagenet import ImageNetFolder, default_transform, load_imagenet, read_synset_mapping
from .pipeline import prefetch_to_device
from .splits import split_by_class

__all__ = ["ArrayDataset", "ImageNetFolder", "as_array_dataset", "default_transform",
           "load_imagenet", "prefetch_to_device", "read_synset_mapping", "split_by_class"]
