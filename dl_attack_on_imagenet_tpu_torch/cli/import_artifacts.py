"""Import reference-trained attack artifacts into the port's cache.

Port of ``dl_attack_on_imagenet_tpu/cli/import_artifacts.py``: a one-shot
migration of the reference's torch-pickle memoization files
(``utils/import_reference.py``). After the import the attack classes find
the trained artifact through their own memoization and go straight to
inference.

Usage:
  python -m dl_attack_on_imagenet_tpu_torch.cli.import_artifacts \
      --kind adil --model resnet18 --src trained_dicts/ImageNet_resnet.bin
  python -m dl_attack_on_imagenet_tpu_torch.cli.import_artifacts \
      --kind adilr --model vgg11 --src dict_model.bin --lam1 0.1 --lam2 0.1
  python -m dl_attack_on_imagenet_tpu_torch.cli.import_artifacts \
      --kind uappgd --model resnet18 --src attack.bin
  python -m dl_attack_on_imagenet_tpu_torch.cli.import_artifacts \
      --kind universal --src pert.npy --out pert_nhwc.npy

``--backend orbax`` is refused (``utils/checkpoint.py`` says why).
"""

from __future__ import annotations

import argparse
import os

from ..utils import ArtifactCache, import_adil, import_adilr, import_uap, import_universal


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adil-import-artifacts")
    p.add_argument("--kind", required=True,
                   choices=["adil", "adilr", "uappgd", "fastuap", "universal"])
    p.add_argument("--src", required=True, help="reference artifact path")
    p.add_argument("--model", default=None,
                   help="victim model name the artifact was trained against")
    p.add_argument("--cache", default=None,
                   help="ArtifactCache root to write into (default: each "
                        "attack class's own default root — trained_dicts, "
                        "or dict_model_ImageNet for adilr)")
    p.add_argument("--backend", default="msgpack", choices=["msgpack", "orbax"])
    # ADILR's memoization keys; the --tag default is the ADILR class's own,
    # so that a default-flags import is found by a default-flags ADILR.
    p.add_argument("--lam1", type=float, default=0.1)
    p.add_argument("--lam2", type=float, default=0.1)
    p.add_argument("--atoms", type=int, default=None)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--tag", default="param_selecting")
    p.add_argument("--out", default=None, help="output .npy (kind=universal)")
    return p


def main(argv=None) -> str:
    args = build_argparser().parse_args(argv)
    if args.kind == "universal":
        out = args.out or os.path.splitext(args.src)[0] + "_nhwc.npy"
        path = import_universal(args.src, out)
    else:
        if not args.model:
            raise SystemExit("--model is required for attack artifacts")
        # Each class's default root: ADIL, UAPPGD and FastUAP read
        # trained_dicts, ADILR dict_model_ImageNet.
        root = args.cache or ("dict_model_ImageNet" if args.kind == "adilr"
                              else "trained_dicts")
        cache = ArtifactCache(root, backend=args.backend)
        if args.kind == "adil":
            path = import_adil(args.src, cache, args.model)
        elif args.kind == "adilr":
            path = import_adilr(args.src, cache, args.model, args.lam1, args.lam2,
                                args.atoms, args.steps, args.tag)
        else:
            kind = "UAPPGD" if args.kind == "uappgd" else "FastUAP"
            path = import_uap(args.src, cache, args.model, kind)
    print(f"imported {args.kind} artifact -> {path}")
    return path


if __name__ == "__main__":
    main()
