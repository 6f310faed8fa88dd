"""The ConvNeXt-B cell's parts on the CPU: a tiny ``convnext_mini`` twin of
``convnext_b-fp32.attack-sup`` run whole, in a copy of the benchmark to
which it is added as new files, reporting no device metric and failing
its check under each fault; ConvNeXt-B's stored parameter count and FLOPs
recounted on the plain reference (on the meta device: shapes only); the
depthwise roofline's arithmetic; both new readers on fixed device totals,
and finding nothing off the card, without the span or in a program
without the device clock; the reference importing nothing of the port.

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
from torch.utils.flop_counter import FlopCounterMode

from dl_attack_on_imagenet_tpu_torch.utils import profiling
from h100bench import faults, harness
from h100bench.reference import convnext as reference

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 2311
CELL = "convnext_b-fp32.attack-sup"
CONFIG = json.loads((ROOT / "h100bench" / "configs" / "convnext_b-fp32.json").read_text())
TINY = dict(program_model="convnext_mini", input_size=64, dims=[16, 32, 64], depths=[2, 1, 2])
METRICS = ("convnext_dwconv_share.attack", "convnext_dwconv_roofline")
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
    (bench / "configs" / "tiny-convnext.json").write_text(json.dumps(
        dict(CONFIG, name="tiny-convnext", **TINY)))
    (bench / "mixes" / "tiny-sup.json").write_text(json.dumps(
        {"job": "attack", "mode": "supervised", "batch": 4, "steps_inference": 30}))
    shutil.copy(bench / "limits" / f"{CELL}.json", bench / "limits" / "tiny-convnext.sup.json")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-convnext.sup", "config": "tiny-convnext",
                              "traffic": "tiny-sup", "chips": 1, "why": "a tiny rehearsal cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-convnext.sup")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_twin_runs_and_reports_no_device_metric_on_the_cpu(tiny_root, trace):
    script = (
        "import json, sys, time; from pathlib import Path; import torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path.insert(0, {str(tiny_root)!r})\n"
        "from h100bench import harness\n"
        f"r = harness.run_cell(Path({str(tiny_root)!r}), 'tiny-convnext.sup', {SEED}, 0.2, "
        f"{trace}, torch.device('cpu'), time.perf_counter(), {str(tiny_root / 'work')!r})\n"
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
        line = harness.run_cell(tiny_root, "tiny-convnext.sup", SEED, 0.2, False,
                                torch.device("cpu"), time.perf_counter(), str(tmp_path))
    assert line["correct"] is False, line["checks"]


def test_stored_parameters_and_flops_per_image():
    """``count_flops.count``'s measure, on the meta device: the forward and
    the input-gradient backward of a batch of two, per image."""
    params = {name: torch.empty(shape, device="meta")
              for name, shape, _ in reference.param_specs(CONFIG)}
    assert sum(p.numel() for p in params.values()) == CONFIG["parameters"] == 88_591_464
    x = torch.empty((2, 224, 224, 3), device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        out = reference.model(params, CONFIG)(x)
        forward = fc.get_total_flops()
        torch.autograd.grad(out.sum(), x)
        total = fc.get_total_flops()
    assert {"forward": forward // 2, "input_grad_backward": (total - forward) // 2} \
        == CONFIG["flops_per_image"]


def reader(name):
    return harness.load_metric(harness.BENCH_DIR, name)


def roofline_module():
    """The roofline reader's module, as the harness loads it."""
    return SimpleNamespace(**reader("convnext_dwconv_roofline").__globals__)


def test_roofline_arithmetic():
    mod = roofline_module()
    n = mod.elements(CONFIG)
    assert n == 4_666_368
    # Bound by bytes each way: 8 and 12 B an element at 3.35 TB/s.
    assert 64 * mod.pass_seconds(n, 49, grad=False) == pytest.approx(8 * 64 * n / 3.35e12)
    assert 64 * mod.pass_seconds(n, 49, grad=True) * 1e3 == pytest.approx(1.783, abs=5e-4)
    assert mod.least_seconds(CONFIG, [(64, True), (64, False)]) == pytest.approx(
        64 * (2 * mod.pass_seconds(n, 49, False) + 12 * n / 3.35e12))


def test_readers_on_fixed_device_totals(monkeypatch):
    totals = {"victim/convnext/dwconv": profiling.DeviceTotal(72, 0.004, 0.006),
              "victim/convnext/mlp": profiling.DeviceTotal(72, 0.03, 0.05)}
    monkeypatch.setattr(profiling, "device_totals", lambda: dict(totals))
    passes = [(64, False), (64, True)]
    ctx = SimpleNamespace(on_device=True, trace=SimpleNamespace(busy_s=0.2), config=CONFIG,
                          passes=passes)
    assert reader(METRICS[0])(ctx) == pytest.approx(5.0)
    least = roofline_module().least_seconds(CONFIG, passes)
    assert reader(METRICS[1])(ctx) == pytest.approx(100.0 * least / 0.01)
    off = SimpleNamespace(on_device=False, trace=None, config=CONFIG, passes=passes)
    assert all(reader(n)(off) is None for n in METRICS)
    monkeypatch.setattr(profiling, "device_totals", dict)  # a victim without the span
    assert all(reader(n)(ctx) is None for n in METRICS)
    monkeypatch.delattr(profiling, "device_totals")  # a program without the device clock
    assert all(reader(n)(ctx) is None for n in METRICS)


def test_reference_loads_nothing_of_the_port():
    script = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
              "from h100bench.reference import convnext\n"
              "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         check=True, timeout=300)
    assert not set(out.stdout.split()) & {"jax", "jaxlib", "flax", "dl_attack_on_imagenet_tpu",
                                          "dl_attack_on_imagenet_tpu_torch"}
