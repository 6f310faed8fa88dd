"""ILSVRC ImageNet on-disk reader: folder scan, synset mapping, transform.

Port of ``dl_attack_on_imagenet_tpu/data/imagenet.py``. PIL decodes on the
host and is imported only where an image is decoded, so the rest of the
package runs on a machine without it. The transform is torchvision's
Resize(256) + CenterCrop(224) + ToTensor, in HWC layout.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dataset import ArrayDataset

TRAIN_SUBDIR = os.path.join("Data", "train")
VAL_SUBDIR = os.path.join("Data", "val")
SYNSET_FILE = "LOC_synset_mapping.txt"


def read_synset_mapping(path: str) -> Dict[str, str]:
    """wnid -> human label ('n01440764' -> 'tench, Tinca tinca')."""
    mapping: Dict[str, str] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            parts = line.split(" ", 1)
            mapping[parts[0]] = parts[1] if len(parts) > 1 else parts[0]
    return mapping


def resized_dims(w: int, h: int, resize: int) -> tuple:
    """(new_w, new_h) of torchvision Resize(shorter side -> ``resize``).

    The long side is ``int(resize * long / short)``: truncation, as
    torchvision computes it, not rounding. ``native/host_loader.cpp`` does
    the same.
    """
    if w <= h:
        return resize, int(resize * h / w)
    return int(resize * w / h), resize


def default_transform(img, size: int = 224, resize: int = 256) -> np.ndarray:
    """Resize (shorter side -> ``resize``), center crop ``size``, [0, 1]
    float32 HWC."""
    from PIL import Image

    w, h = img.size
    img = img.resize(resized_dims(w, h, resize), Image.BILINEAR)
    w, h = img.size
    # torchvision's center_crop rounds the half margin, half to even.
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img.convert("RGB"), np.float32) / 255.0


class ImageNetFolder:
    """Directory-of-wnid-folders dataset, decoded lazily.

    ``root/ILSVRC/Data/<split>/<wnid>/*.JPEG``, or ``root`` pointing at the
    split directory itself. ``classes`` holds the first comma-separated
    token of each class's human label where ``LOC_synset_mapping.txt`` is
    found, else the wnids.
    """

    def __init__(self, root: str, split: str = "val", transform=default_transform,
                 image_size: int = 224):
        subdir = TRAIN_SUBDIR if split == "train" else VAL_SUBDIR
        data_dir = os.path.join(root, "ILSVRC", subdir)
        if not os.path.isdir(data_dir):
            data_dir = root
        self.root = data_dir
        self.transform = transform
        self.image_size = image_size

        wnids = sorted(d for d in os.listdir(data_dir)
                       if os.path.isdir(os.path.join(data_dir, d)))
        if not wnids:
            raise FileNotFoundError(f"no class folders under {data_dir}")
        self.wnids = wnids
        self.class_to_idx = {w: i for i, w in enumerate(wnids)}

        synset_path = os.path.join(root, "ILSVRC", SYNSET_FILE)
        if not os.path.exists(synset_path):
            synset_path = os.path.join(root, SYNSET_FILE)
        if os.path.exists(synset_path):
            mapping = read_synset_mapping(synset_path)
            self.classes = [mapping.get(w, w).split(",", 1)[0] for w in wnids]
        else:
            self.classes = list(wnids)

        self.samples: List[Tuple[str, int]] = []
        for w in wnids:
            cdir = os.path.join(data_dir, w)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith((".jpeg", ".jpg", ".png")):
                    self.samples.append((os.path.join(cdir, fname), self.class_to_idx[w]))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        path, label = self.samples[i]
        return self.load_image(path), label

    def load_image(self, path: str) -> np.ndarray:
        """Decode and transform one file."""
        from PIL import Image

        with open(path, "rb") as f:
            return self.transform(Image.open(f), size=self.image_size)

    def materialize(self, indices: Optional[Sequence[int]] = None,
                    runtime=None) -> ArrayDataset:
        """Decode (a subset of) the dataset into an ArrayDataset: on the
        native loader's thread pool when ``runtime`` is given, else with PIL
        one image after another."""
        idxs = np.arange(len(self)) if indices is None else np.asarray(indices)
        if runtime is not None:
            images = runtime.decode_batch([self.samples[int(i)][0] for i in idxs],
                                          self.image_size)
        else:
            images = np.stack([self[int(i)][0] for i in idxs])
        labels = np.asarray([self.samples[int(i)][1] for i in idxs], np.int64)
        return ArrayDataset(images, labels)


def load_imagenet(root: str = "./data/ImageNet", split: str = "val") -> ImageNetFolder:
    """The lazy folder dataset of one split (its class names in ``.classes``)."""
    return ImageNetFolder(root, split=split)
