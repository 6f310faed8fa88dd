"""Batch adversarial generation: the serving path.

Port of ``dl_attack_on_imagenet_tpu/cli/generate.py``: streams a dataset
blob (``cli.dataset``) or an ILSVRC folder through a trained ADiL dictionary
in fixed-size batches and writes a JSONL report (per batch: rows, fooling
rate, mean squared perturbation, seconds), ``summary.json`` and, with
``--save-images``, one ``adv_{i:06d}.png`` an image. Batches reach the card
through the two-deep copy lookahead of ``data.prefetch_to_device``; a folder
decodes on the native loader's threads where it builds, else with PIL.

The blob's last batch runs at its own, shorter size. The folder path pads a
batch by cycling its valid rows up to the batch size, as the JAX package
does to keep one compiled shape; metrics and images use the first ``k``
rows only.

Usage:
  python -m dl_attack_on_imagenet_tpu_torch.cli.generate \
      --model resnet50 --data-root ./data/ImageNet --out-dir ./adv \
      [--blob imagenet_val.npz] [--batch-size 128] [--mode supervised] [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adil-generate")
    p.add_argument("--model", default="resnet50")
    p.add_argument("--data-root", default="./data/ImageNet")
    p.add_argument("--blob", default=None, help="npz blob from cli.dataset")
    p.add_argument("--out-dir", default="./adv_out")
    p.add_argument("--dict-dir", default="trained_dicts")
    # The JAX package's default; the reference hardcodes a batch of 100.
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--mode", default="supervised",
                   choices=["supervised", "unsupervised"])
    p.add_argument("--eps", type=float, default=8 / 255)
    p.add_argument("--steps-inference", type=int, default=100)
    p.add_argument("--save-images", action="store_true",
                   help="write adversarial PNGs (default: metrics only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--input-size", type=int, default=None,
                   help="victim input size; default 224 for every ImageNet victim, "
                        "Inception included, and the native size for the tiny test victim")
    from ._victim import add_victim_args

    add_victim_args(p)
    p.add_argument("--mixed-precision", action="store_true",
                   help="perturb_dtype=bfloat16: bf16 inner forwards, fp32 "
                        "master state and budget clamps")
    return p


def _blob_batches(path: str, limit: int, b: int):
    from .dataset import load_blob

    ds, _ = load_blob(path)
    images, labels = ds.images, ds.labels
    if limit:
        images, labels = images[:limit], labels[:limit]
    for s in range(0, len(images), b):
        xb = images[s:s + b]
        yield s, xb, labels[s:s + b], len(xb)


def _folder_batches(root: str, size: int, limit: int, b: int):
    from ..data.imagenet import ImageNetFolder
    from ..runtime import HostLoader, get_runtime

    folder = ImageNetFolder(root, image_size=size)
    n = min(limit or len(folder), len(folder))
    runtime = get_runtime()
    if runtime is None:
        for s in range(0, n, b):
            sub = folder.materialize(range(s, min(s + b, n)))
            yield s, sub.images, sub.labels, len(sub)
        return
    loader = HostLoader(runtime, [p for p, _ in folder.samples[:n]],
                        [c for _, c in folder.samples[:n]], b, size)
    try:
        for idx, x, y, _ in loader.iter_indexed():
            # Padding (-1) and failed decodes (-2) are replaced by cycled
            # valid rows, so every batch has the batch size.
            keep = y >= 0
            if not keep.any():
                continue
            xk, yk = x[keep], y[keep]
            if len(xk) < b:
                reps = -(-b // len(xk))
                xk = np.concatenate([xk] * reps)[:b]
                yk = np.concatenate([yk] * reps)[:b]
            yield idx * b, xk, yk, int(keep.sum())
    finally:
        loader.close()


def main(args) -> dict:
    from ..attacks import ADIL
    from ..data import prefetch_to_device
    from ..utils import ArtifactCache, MetricLogger
    from ._victim import build_victim

    victim = build_victim(args)
    device = victim.device
    attack = ADIL(
        victim, eps=args.eps, model_name=args.model, attack=args.mode,
        steps_inference=args.steps_inference, cache=ArtifactCache(args.dict_dir),
        perturb_dtype="bfloat16" if getattr(args, "mixed_precision", False) else "float32",
    )
    if args.blob:
        host = _blob_batches(args.blob, args.limit, args.batch_size)
    else:
        host = _folder_batches(args.data_root, victim.input_size, args.limit,
                               args.batch_size)

    # Each batch's (start, k) stays on the host: only the arrays go through
    # the lookahead, and the host numbers come back in the same order.
    meta = collections.deque()

    def arrays():
        for start, x, y, k in host:
            meta.append((int(start), int(k)))
            yield np.asarray(x, np.float32), np.asarray(y, np.int64)

    os.makedirs(args.out_dir, exist_ok=True)
    log = MetricLogger(os.path.join(args.out_dir, "report.jsonl"))
    total = 0
    fooled = 0.0
    t0 = time.time()
    for x, y in prefetch_to_device(arrays(), size=2, device=device):
        start, k = meta.popleft()
        tb = time.time()
        adv = attack(x, y)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - tb
        with torch.no_grad():
            x_r, adv_r = x[:k], adv[:k]
            batch_fool = float(torch.sum(victim.predict(x_r) != victim.predict(adv_r)))
            mse = float(torch.mean(torch.sum((adv_r - x_r) ** 2, dim=(1, 2, 3))))
        total += k
        fooled += batch_fool
        log.log(start, n=k, fooling=batch_fool / k, mse=mse, seconds=dt)
        if args.save_images:
            from PIL import Image

            # float32 product, then truncation to uint8, as the JAX package writes.
            arr = (torch.clamp(adv_r, 0, 1) * 255).cpu().numpy().astype(np.uint8)
            for j in range(arr.shape[0]):
                Image.fromarray(arr[j]).save(os.path.join(args.out_dir, f"adv_{start + j:06d}.png"))

    seconds = time.time() - t0
    summary = {
        "total": total,
        "fooling_rate": fooled / max(total, 1),
        "seconds": seconds,
        "images_per_sec": total / max(seconds, 1e-9),
    }
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(build_argparser().parse_args())
