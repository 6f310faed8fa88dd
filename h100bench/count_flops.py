"""Count a configuration's model FLOPs per image on its plain reference.

    python3 h100bench/count_flops.py <config> [--batch 2]

Runs the reference's forward and its input-gradient backward (the victim
is frozen: no weight gradient) on the CPU under
``torch.utils.flop_counter.FlopCounterMode`` at a small batch and prints
the counts per image, which ``configs/<config>.json`` stores as
``flops_per_image``. FlopCounterMode counts the matrix products and
convolutions, not the elementwise work.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

if not __package__:  # run as a script: load the benchmark as ``h100bench``
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from h100bench import inputs  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent


def count(config: dict, batch: int = 2) -> dict:
    """{"forward": ..., "input_grad_backward": ...} FLOPs per image."""
    params = inputs.weights(config, 0, torch.device("cpu"))
    model = inputs.architecture(config).model(params, config)
    x = inputs.images(0, "flops", batch, config["input_size"], "cpu").requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        out = model(x)
        fwd = fc.get_total_flops()
        torch.autograd.grad(out.sum(), x)
        total = fc.get_total_flops()
    return {"forward": fwd // batch, "input_grad_backward": (total - fwd) // batch}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("--batch", type=int, default=2)
    args = p.parse_args()
    with open(BENCH_DIR / "configs" / f"{args.config}.json") as f:
        config = json.load(f)
    print(json.dumps(count(config, args.batch)))


if __name__ == "__main__":
    main()
