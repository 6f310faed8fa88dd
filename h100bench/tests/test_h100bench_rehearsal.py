"""A whole run rehearsed on the CPU at a tiny size, in a copy of the
benchmark to which cells are added as new files only; the harness's
refusals; and the faults its check has to catch.

    python -m pytest h100bench/tests -q -p no:cacheprovider   (from the root)

The tiny cells run the real configurations' architectures with the port's
``resnet50`` at 32x32 and its ``vit_tiny`` (the references built from the
same widths), on the CPU, where the port takes its kernels' plain twins.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from h100bench import faults, harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 977
torch.set_num_threads(1)
CONFIGS = {
    "tiny-resnet": ("resnet50-fp32", dict(input_size=32)),
    "tiny-vit": ("vit_b16-fp32", dict(program_model="vit_tiny", input_size=32, num_layers=2,
                                      num_heads=4, hidden_dim=64, mlp_dim=128)),
}
MIXES = {
    "tiny-learn": {"job": "learn", "images": 8, "epochs": 500, "batch": 4, "pipeline_epochs": "auto"},
    "tiny-sup": {"job": "attack", "mode": "supervised", "batch": 4, "steps_inference": 30},
    "tiny-unsup": {"job": "attack", "mode": "unsupervised", "batch": 4, "trials": 3,
                   "tie_margin": 0.001},
}
# cell: (config, mix, the real cell whose limits it is held to)
CELLS = {
    "tiny-resnet.learn": ("tiny-resnet", "tiny-learn", "resnet50-fp32.learn"),
    "tiny-resnet.sup": ("tiny-resnet", "tiny-sup", "resnet50-fp32.attack-sup"),
    "tiny-vit.sup": ("tiny-vit", "tiny-sup", "vit_b16-fp32.attack-sup"),
    "tiny-resnet.unsup": ("tiny-resnet", "tiny-unsup", "resnet50-fp32.attack-unsup"),
}


def write(path: Path, obj) -> None:
    assert not path.exists(), f"{path} exists: a new cell adds files, it edits none"
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout with the tiny cells added: new config, mix and limits
    files, and new entries in BENCHMARK.json."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "h100bench", root / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "dl_attack_on_imagenet_tpu_torch").symlink_to(ROOT / "dl_attack_on_imagenet_tpu_torch")
    bench = root / "h100bench"
    for name, (base, changes) in CONFIGS.items():
        config = json.loads((bench / "configs" / f"{base}.json").read_text())
        write(bench / "configs" / f"{name}.json", dict(config, name=name, **changes))
    for name, mix in MIXES.items():
        write(bench / "mixes" / f"{name}.json", mix)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (config, mix, real) in CELLS.items():
        write(bench / "limits" / f"{name}.json",
              json.loads((bench / "limits" / f"{real}.json").read_text()))
        spec["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1,
                                  "why": "a tiny rehearsal cell"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run_in(root: Path, cell: str, trace: bool, timeout: int = 600):
    script = (
        "import json, sys, time; from pathlib import Path; import torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from h100bench import harness\n"
        f"r = harness.run_cell(Path({str(root)!r}), {cell!r}, {SEED}, 0.2, {trace}, "
        f"torch.device('cpu'), time.perf_counter(), {str(root / 'work')!r})\n"
        "print(json.dumps(r))\n")
    (root / "work").mkdir(exist_ok=True)
    return subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=timeout, cwd=root)


@pytest.mark.parametrize("cell, trace", [(c, False) for c in CELLS] + [("tiny-resnet.sup", True),
                                                                       ("tiny-resnet.learn", True)])
def test_added_cell_runs_and_reports_no_device_metric_on_the_cpu(tiny_root, cell, trace):
    out = run_in(tiny_root, cell, trace)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu" and "busy_s" not in line["device"]
    metrics = set(line["metrics"])
    if trace:  # only the counters and the host's clock; no device metric
        assert metrics == ({"victim_passes.attack"} if "sup" in cell else {"job_start_s"})
    else:
        rate = "train_images_per_s" if "learn" in cell else "attack_images_per_s"
        assert metrics == {rate, "setup_s"}
    for check in line["checks"].values():
        assert check["value"] <= check["limit"]


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                          "resnet50-fp32.attack-sup", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_with_only_the_benchmark(tmp_path):
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = run_in(tmp_path, "resnet50-fp32.attack-sup", False, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell, fault", [
    ("tiny-resnet.learn", "unchanged"), ("tiny-resnet.learn", "half_batch"),
    ("tiny-resnet.sup", "unchanged"), ("tiny-resnet.sup", "half_batch"),
    ("tiny-resnet.sup", "altered"), ("tiny-vit.sup", "unchanged"), ("tiny-vit.sup", "half_batch"),
    ("tiny-vit.sup", "altered"), ("tiny-resnet.unsup", "altered"),
])
def test_check_catches_a_broken_timed_path(tiny_root, tmp_path, cell, fault):
    with faults.planted(fault):
        line = harness.run_cell(tiny_root, cell, SEED, 0.2, False, torch.device("cpu"),
                                time.perf_counter(), str(tmp_path))
    assert line["correct"] is False, line["checks"]
