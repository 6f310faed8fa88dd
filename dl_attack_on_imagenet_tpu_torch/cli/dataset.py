"""Dataset materialization CLI: scan an ILSVRC tree, decode, save one blob.

Port of ``dl_attack_on_imagenet_tpu/cli/dataset.py``: the validation (or
train) split with the Resize(256) + CenterCrop(224) transform, saved as one
``np.savez_compressed`` blob (images float32 NHWC in [0, 1], labels int64,
class names as an object array) that :func:`load_blob` reloads without
decoding again. The blob is the JAX package's, byte for byte in its arrays,
so a blob written by either package loads in the other. The native decode
pool runs unless ``--no-native``; without it PIL decodes.

Usage: python -m dl_attack_on_imagenet_tpu_torch.cli.dataset \
           --root ./data/ImageNet --split val --out imagenet_val.npz
"""

from __future__ import annotations

import argparse

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adil-dataset")
    p.add_argument("--root", "-r", default="./data/ImageNet",
                   help="ImageNet root containing ILSVRC/ (default ./data/ImageNet)")
    p.add_argument("--split", default="val", help="train or val (default val)")
    p.add_argument("--out", default="ImageNet1000_unnormalized.npz",
                   help="output blob path")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--limit", type=int, default=0,
                   help="decode only the first N images (0 = all)")
    p.add_argument("--no-native", action="store_true",
                   help="force the PIL decode path")
    return p


def save_blob(path: str, images: np.ndarray, labels: np.ndarray, classes) -> None:
    """Write the blob :func:`load_blob` reads."""
    np.savez_compressed(
        path,
        images=np.asarray(images, np.float32),
        labels=np.asarray(labels, np.int64),
        classes=np.asarray(list(classes), dtype=object),
    )


def main(args) -> str:
    from ..data.imagenet import ImageNetFolder

    runtime = None
    if not args.no_native:
        from ..runtime import get_runtime

        runtime = get_runtime()

    folder = ImageNetFolder(args.root, split=args.split, image_size=args.image_size)
    indices = None
    if args.limit:
        indices = np.arange(min(args.limit, len(folder)))
    ds = folder.materialize(indices, runtime=runtime)
    save_blob(args.out, ds.images, ds.labels, folder.classes)
    print(f"saved {len(ds)} images ({ds.images.nbytes / 1e6:.1f} MB raw) to {args.out}")
    return args.out


def load_blob(path: str):
    """Reload a blob saved by this CLI (or the JAX package's) ->
    (ArrayDataset, classes)."""
    from ..data import ArrayDataset

    blob = np.load(path, allow_pickle=True)
    return ArrayDataset(blob["images"], blob["labels"]), list(blob["classes"])


if __name__ == "__main__":
    main(build_argparser().parse_args())
