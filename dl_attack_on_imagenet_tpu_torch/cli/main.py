"""Single-image ADiL demo: attack one image with a trained dictionary and draw
a 3-panel figure (original | perturbation | adversarial).

Port of ``dl_attack_on_imagenet_tpu/cli/main.py``, in two parts:
:func:`attack_image` builds the victim, loads the image (or makes a seeded
synthetic one where no ``--image`` is given) and attacks it with supervised
DDrague; :func:`save_figure` draws the figure, with matplotlib imported
there only. Panel captions name the model's own predictions.

Usage: python -m dl_attack_on_imagenet_tpu_torch.cli.main --model resnet50 \
           [--image path.JPEG] [--data-root ./data/ImageNet] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adil-demo")
    p.add_argument("--model", "-m", default="mobilenet",
                   help="victim: resnet|densenet|googlenet|inception|mobilenet|vgg|vit "
                        "(the port has the ResNets and tiny so far)")
    p.add_argument("--image", default=None, help="path to a JPEG to attack")
    p.add_argument("--data-root", default="./data/ImageNet")
    p.add_argument("--eps", type=float, default=8 / 255)
    p.add_argument("--steps-inference", type=int, default=100)
    p.add_argument("--dict-dir", default="trained_dicts")
    p.add_argument("--out", default="attack_samples.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--input-size", type=int, default=None,
                   help="victim input size; default 224 for every ImageNet victim, "
                        "the native size for the tiny test victim")
    from ._victim import add_victim_args

    add_victim_args(p)
    return p


def synthetic_image(size: int) -> np.ndarray:
    """The seeded (size, size, 3) image in [0, 1) that :func:`attack_image`
    attacks where no ``--image`` is given, so that the demo runs without the
    dataset."""
    return np.random.default_rng(1).random((size, size, 3), dtype=np.float32)


def attack_image(args):
    """Attack one image: returns ``(x, adversary, label, attack_label)``,
    the image batch (1, S, S, 3) and its adversary on the victim's device
    and their predicted labels. Where no dictionary is saved under
    ``--dict-dir`` for ``--model``, ADIL learns one on this image first."""
    from ..attacks import ADIL
    from ..utils import ArtifactCache
    from ._victim import build_victim

    victim = build_victim(args)
    size = victim.input_size
    if args.image and os.path.exists(args.image):
        from PIL import Image

        from ..data.imagenet import default_transform

        with open(args.image, "rb") as f:
            im = default_transform(Image.open(f), size=size)
    else:
        im = synthetic_image(size)

    attack = ADIL(victim, eps=args.eps, model_name=args.model,
                  steps_inference=args.steps_inference, cache=ArtifactCache(args.dict_dir))
    x = torch.as_tensor(im, dtype=torch.float32, device=victim.device)[None]
    with torch.no_grad():
        label = victim.predict(x)
    adversary = attack(x, label)
    with torch.no_grad():
        attack_label = victim.predict(adversary)
    return x, adversary, label, attack_label


def save_figure(args, x, adversary, label, attack_label) -> str:
    """Draw original | perturbation | adversarial into ``args.out``; class
    names come from the ImageNet folder where ``--image`` and the folder
    exist."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..data.imagenet import load_imagenet

    classes = None
    if args.image and os.path.exists(args.image):
        try:
            classes = load_imagenet(args.data_root).classes
        except FileNotFoundError:
            classes = None

    def name_of(idx):
        i = int(idx)
        return classes[i] if classes and i < len(classes) else f"class {i}"

    x0, adv0 = x[0].cpu().numpy(), adversary[0].cpu().numpy()
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    axes[0].imshow(x0)
    axes[0].set_title(f"original: {name_of(label[0])}", fontsize=18)
    pert = adv0 - x0
    scaled = (pert + args.eps) / max(float(np.max(pert + args.eps)), 1e-9)
    axes[1].imshow(np.clip(scaled, 0, 1))
    axes[1].set_title("perturbation", fontsize=18)
    axes[2].imshow(adv0)
    axes[2].set_title(f"attack: {name_of(attack_label[0])}", fontsize=18)
    for ax in axes:
        ax.set_axis_off()
    fig.tight_layout(pad=0.5)
    fig.savefig(args.out)
    plt.close(fig)
    print(f"label {int(label[0])} ({name_of(label[0])}) -> "
          f"{int(attack_label[0])} ({name_of(attack_label[0])}); figure: {args.out}")
    return args.out


def main(args) -> str:
    return save_figure(args, *attack_image(args))


if __name__ == "__main__":
    main(build_argparser().parse_args())
