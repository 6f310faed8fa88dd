"""The Swin-B cell's parts on the CPU: a tiny ``swin_tiny`` twin of
``swin_b-fp32.attack-sup`` run whole, in a copy of the benchmark to which
it is added as new files, reporting no device metric and failing its
check under each fault; Swin-B's stored FLOPs recounted on the plain
reference; the readers of the span shares on fixed device totals, and
finding nothing off the card or in a program without the device clock;
the reference importing nothing of the port.

    python -m pytest h100bench/tests -q -p no:cacheprovider   (from the root)
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from dl_attack_on_imagenet_tpu_torch.utils import profiling
from h100bench import count_flops, faults, harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 1193
CELL = "swin_b-fp32.attack-sup"
TINY = dict(program_model="swin_tiny", input_size=64, embed_dim=16, depths=[2, 2, 2],
            num_heads=[2, 4, 8], window_size=4)
SHARES = ("swin_attention_share.attack", "swin_shift_share.attack")
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout with the tiny twin added: its configuration, its mix and
    the real cell's limits as new files, and new entries in
    BENCHMARK.json."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "h100bench", root / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "dl_attack_on_imagenet_tpu_torch").symlink_to(ROOT / "dl_attack_on_imagenet_tpu_torch")
    bench = root / "h100bench"
    config = json.loads((bench / "configs" / "swin_b-fp32.json").read_text())
    (bench / "configs" / "tiny-swin.json").write_text(json.dumps(dict(config, name="tiny-swin",
                                                                     **TINY)))
    (bench / "mixes" / "tiny-sup.json").write_text(json.dumps(
        {"job": "attack", "mode": "supervised", "batch": 4, "steps_inference": 30}))
    shutil.copy(bench / "limits" / f"{CELL}.json", bench / "limits" / "tiny-swin.sup.json")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-swin.sup", "config": "tiny-swin", "traffic": "tiny-sup",
                              "chips": 1, "why": "a tiny rehearsal cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-swin.sup")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_twin_runs_and_reports_no_device_metric_on_the_cpu(tiny_root, trace):
    script = (
        "import json, sys, time; from pathlib import Path; import torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path.insert(0, {str(tiny_root)!r})\n"
        "from h100bench import harness\n"
        f"r = harness.run_cell(Path({str(tiny_root)!r}), 'tiny-swin.sup', {SEED}, 0.2, {trace}, "
        f"torch.device('cpu'), time.perf_counter(), {str(tiny_root / 'work')!r})\n"
        "print(json.dumps(r))\n")
    (tiny_root / "work").mkdir(exist_ok=True)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["device"]["platform"] == "cpu"
    want = {"victim_passes.attack"} if trace else {"attack_images_per_s", "setup_s"}
    assert set(line["metrics"]) == want


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_tiny_twin_check_catches_a_broken_timed_path(tiny_root, tmp_path, fault):
    with faults.planted(fault):
        line = harness.run_cell(tiny_root, "tiny-swin.sup", SEED, 0.2, False, torch.device("cpu"),
                                time.perf_counter(), str(tmp_path))
    assert line["correct"] is False, line["checks"]


def test_stored_flops_per_image():
    config = json.loads((ROOT / "h100bench" / "configs" / "swin_b-fp32.json").read_text())
    assert count_flops.count(config, batch=1) == config["flops_per_image"]


def reader(name):
    return harness.load_metric(harness.BENCH_DIR, name)


def test_share_readers_on_fixed_device_totals(monkeypatch):
    totals = {"victim/swin/attention": profiling.DeviceTotal(48, 3.0, 6.0),
              "victim/swin/shift": profiling.DeviceTotal(96, 0.5, 0.7),
              "victim/swin/mlp": profiling.DeviceTotal(48, 2.0, 4.0)}
    monkeypatch.setattr(profiling, "device_totals", lambda: dict(totals))
    ctx = SimpleNamespace(on_device=True, trace=SimpleNamespace(busy_s=20.0))
    assert reader(SHARES[0])(ctx) == pytest.approx(45.0)
    assert reader(SHARES[1])(ctx) == pytest.approx(6.0)
    assert all(reader(n)(SimpleNamespace(on_device=False, trace=None)) is None for n in SHARES)
    monkeypatch.setattr(profiling, "device_totals", dict)  # a victim without the spans
    assert all(reader(n)(ctx) is None for n in SHARES)
    monkeypatch.delattr(profiling, "device_totals")  # a program without the device clock
    assert all(reader(n)(ctx) is None for n in SHARES)


def test_reference_loads_nothing_of_the_port():
    script = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
              "from h100bench.reference import swin\n"
              "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         check=True, timeout=300)
    assert not set(out.stdout.split()) & {"jax", "jaxlib", "flax", "dl_attack_on_imagenet_tpu",
                                          "dl_attack_on_imagenet_tpu_torch"}
