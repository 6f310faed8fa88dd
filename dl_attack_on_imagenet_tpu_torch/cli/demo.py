"""Full ADiL experiment: clean accuracy -> class-balanced split -> dictionary
learning over the hyper-grid -> val and test evaluation -> results file.

Port of ``dl_attack_on_imagenet_tpu/cli/demo.py``, in two parts: :func:`main`
builds the victim and the dataset from the arguments (``--synthetic N``: the
tiny victim on N seeded random images; otherwise the ImageNet folder under
``--data-root``, decoded by the native loader where it builds, else by PIL),
and :func:`run_experiment` runs the experiment on any victim and dataset.

Usage: python -m dl_attack_on_imagenet_tpu_torch.cli.demo --model resnet50 \
           --num-train-per-class 10 [--synthetic 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adil-experiment")
    p.add_argument("--model", default="densenet",
                   help="victim (the port has the ResNets and tiny so far)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num-train-per-class", type=int, default=10)
    p.add_argument("--trained-classes", type=int, default=1000)
    p.add_argument("--distributed", action="store_true",
                   help="train the dictionary data-parallel (not ported yet)")
    p.add_argument("--steps-inference", type=int, default=100)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--n-atoms", type=int, default=100)
    p.add_argument("--kappa", type=float, default=50.0)
    p.add_argument("--eps", type=float, default=8 / 255)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--data-root", default="./data/ImageNet")
    p.add_argument("--dict-dir", default="trained_dicts")
    p.add_argument("--results-dir", default="dict_model_ImageNet_version_constrained")
    p.add_argument("--synthetic", type=int, default=0,
                   help=">0: use a synthetic dataset of this size and the tiny victim")
    p.add_argument("--input-size", type=int, default=None,
                   help="victim input size; default 224 for every ImageNet victim "
                        "(the reference's one Resize(256)+CenterCrop(224) transform)")
    p.add_argument("--mixed-precision", action="store_true",
                   help="bfloat16 perturbation forwards (not ported yet)")
    from ._victim import add_victim_args

    add_victim_args(p)
    return p


def main(args) -> dict:
    from ..data import ArrayDataset, load_imagenet
    from ..models import create_model

    if args.distributed:
        raise NotImplementedError("--distributed (data-parallel training) is not ported yet "
                                  "(ROADMAP.md queue 1 item 6)")
    if args.mixed_precision:
        raise NotImplementedError("--mixed-precision (perturb_dtype='bfloat16') is not ported "
                                  "yet (ROADMAP.md queue 1 item 2)")
    if args.synthetic:
        victim = create_model("tiny", seed=args.seed, device=args.device)
        n = args.synthetic
        images = np.random.default_rng(args.seed).random((n, 32, 32, 3), dtype=np.float32)
        # Balanced labels, so that the class split always works.
        dataset = ArrayDataset(images, np.arange(n) % 4)
        return run_experiment(victim, dataset, 4, [2, 1, 1], "tiny", args)

    from ..runtime import get_runtime
    from ._victim import build_victim

    victim = build_victim(args)
    dataset = load_imagenet(args.data_root).materialize(runtime=get_runtime())
    return run_experiment(victim, dataset, args.trained_classes,
                          [args.num_train_per_class, 2, 5], args.model, args)


def run_experiment(victim, dataset, num_classes: int, per_class, model_name: str, args) -> dict:
    """Accuracy, split, ADiL over the hyper-grid (learning its dictionary
    unless ``--dict-dir`` holds one for ``model_name``), val and test
    performance, and the results file under ``--results-dir``. Prints the
    wall of each stage; every stage ends in a host read of its results."""
    from .. import evaluation as perf
    from ..attacks import ADIL
    from ..data import split_by_class
    from ..utils import ArtifactCache, save_artifact

    t0 = time.perf_counter()
    acc = perf.model_accuracy(dataset, victim)
    walls = {"accuracy": time.perf_counter() - t0}
    print(f"accuracy of model {model_name}: {acc * 100:.2f}%")

    train_ds, val_ds, test_ds = split_by_class(dataset, per_class,
                                               number_of_classes=num_classes, seed=args.seed)
    cache = ArtifactCache(args.dict_dir)
    t0 = time.perf_counter()
    attacks_hyper = {
        "adil": perf.get_atks(
            victim, ADIL,
            "n_atoms", [args.n_atoms], "kappa", [args.kappa],
            data_train=train_ds, data_val=val_ds, norm="linf",
            attack="supervised", eps=args.eps, steps=args.steps,
            targeted=False, step_size=0.01,
            batch_size=min(args.batch_size, len(train_ds)),
            model_name=model_name, steps_in=1, loss="logits",
            method="gd", warm_start=False,
            steps_inference=args.steps_inference, cache=cache,
        ),
    }
    walls["dictionary learning"] = time.perf_counter() - t0

    val_loader = [(x, y) for _, x, y in val_ds.batches(min(10, len(val_ds)))]
    test_loader = [(x, y) for _, x, y in test_ds.batches(min(20, len(test_ds)))]
    t0 = time.perf_counter()
    val_perf = perf.get_performance(attacks_hyper, victim, val_loader, verbose=True)
    walls["val"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_perf = perf.get_performance(attacks_hyper, victim, test_loader, verbose=True)
    walls["test"] = time.perf_counter() - t0

    results = {"val": val_perf, "test": test_perf, "accuracy": float(acc)}
    out_path = f"{args.results_dir}/results_{model_name}_seed{args.seed}.msgpack"
    save_artifact(out_path, _flatten(results))
    print(f"saved results to {out_path}")
    print("val:", val_perf)
    print("test:", test_perf)
    print("stage walls (s): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    return results


def _flatten(tree, prefix=""):
    """Flatten nested result dicts into msgpack leaves: numbers become floats
    or float64 arrays, strings and lists of strings pass as they are."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        elif isinstance(v, str):
            flat[key] = v
        elif isinstance(v, (list, tuple)):
            if v and all(isinstance(e, str) for e in v):
                flat[key] = list(v)
            else:
                flat[key] = np.asarray(v, np.float64)
        else:
            flat[key] = float(v)
    return flat


if __name__ == "__main__":
    main(build_argparser().parse_args())
