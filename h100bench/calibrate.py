"""Read the numbers a cell's check compares, for the program and for its
control, over many seeds in one process: the readings its limits are set
from.

    python3 h100bench/calibrate.py --workload <name> --seeds 1,2,3 [--control 1,2]
        [--fault unchanged|half_batch|altered]

For each seed it sets the cell up (which runs one unit of the program's
work), runs one more unit as a run's check does and judges it against the
plain reference. For each control seed it also runs the reference in the
nearest precision below the configuration's (TF32 in cuDNN and cuBLAS for
fp32) in the program's place and judges that the same way: a limit has to
fail it. With ``--fault`` the program runs with that fault planted
(``faults.py``), for the readings a fault gives at the cell's own size.
One JSON line per seed goes to standard output. Needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import torch

if not __package__:  # run as a script: load the benchmark as ``h100bench``
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from h100bench import faults, harness  # noqa: E402


def readings(root: Path, workload: str, seed: int, control: bool, device, workdir: str,
             fault: str = None) -> dict:
    """{"program": ..., "control": ... (with ``control``), "seconds": ...};
    ``fault`` plants that fault in the program for the set-up and the unit
    judged."""
    found = harness.load_cell(root, workload)
    harness.set_precision(found.config["precision"])
    job = importlib.import_module(f"h100bench.jobs.{found.mix['job']}")
    run = SimpleNamespace(config=found.config, mix=found.mix, seed=seed, device=device,
                          workdir=workdir, wanted=list(found.limits["limits"]))
    start = time.perf_counter()
    with faults.planted(fault) if fault else contextlib.nullcontext():
        st = job.setup(run)
        setup = time.perf_counter() - start
        out = dict(seed=seed, **job.calibrate(st, control))
    out["seconds"] = {"setup": setup, "check": time.perf_counter() - start - setup}
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = p.parse_args()
    root = harness.BENCH_DIR.parent
    control = {int(s) for s in args.control.split(",") if s}
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(dir=harness.workdir_root(root)) as workdir:
            row = readings(root, args.workload, seed, seed in control, device, workdir,
                           args.fault)
        print(json.dumps(dict(workload=args.workload, fault=args.fault, **row)), flush=True)


if __name__ == "__main__":
    main()
