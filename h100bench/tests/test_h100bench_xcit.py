"""The XCiT-L12 cell's parts on the CPU: a tiny ``xcit_mini`` twin of
``xcit_l12-fp32.attack-sup`` run whole, in a copy of the benchmark to which
it is added as new files, reporting no device metric and failing its check
under each fault; the reference's ``param_specs`` against the port's
``state_dict``, names and shapes, and the reference against the port at
the small size; XCiT-L12's stored parameter count and FLOPs recounted on
the plain reference (on the meta device: shapes only); the LPI roofline's
arithmetic; the three new readers on fixed device totals, and finding
nothing off the card, without the span or in a program without the device
clock; the reference importing nothing of the port or of JAX.

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

from dl_attack_on_imagenet_tpu_torch.models import create_model
from dl_attack_on_imagenet_tpu_torch.models.xcit import xcit_l12
from dl_attack_on_imagenet_tpu_torch.utils import profiling
from h100bench import faults, harness, inputs, program
from h100bench.reference import xcit as reference

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 2511
CELL = "xcit_l12-fp32.attack-sup"
CONFIG = json.loads((ROOT / "h100bench" / "configs" / "xcit_l12-fp32.json").read_text())
TINY = dict(program_model="xcit_mini", input_size=64, embed_dim=64, depth=2, num_heads=4)
METRICS = ("xcit_xca_share.attack", "xcit_lpi_share.attack", "xcit_lpi_roofline")
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
    (bench / "configs" / "tiny-xcit.json").write_text(json.dumps(
        dict(CONFIG, name="tiny-xcit", **TINY)))
    (bench / "mixes" / "tiny-sup.json").write_text(json.dumps(
        {"job": "attack", "mode": "supervised", "batch": 4, "steps_inference": 30}))
    shutil.copy(bench / "limits" / f"{CELL}.json", bench / "limits" / "tiny-xcit.sup.json")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-xcit.sup", "config": "tiny-xcit",
                              "traffic": "tiny-sup", "chips": 1, "why": "a tiny rehearsal cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-xcit.sup")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_twin_runs_and_reports_no_device_metric_on_the_cpu(tiny_root, trace):
    script = (
        "import json, sys, time; from pathlib import Path; import torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path.insert(0, {str(tiny_root)!r})\n"
        "from h100bench import harness\n"
        f"r = harness.run_cell(Path({str(tiny_root)!r}), 'tiny-xcit.sup', {SEED}, 0.2, "
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
        line = harness.run_cell(tiny_root, "tiny-xcit.sup", SEED, 0.2, False,
                                torch.device("cpu"), time.perf_counter(), str(tmp_path))
    assert line["correct"] is False, line["checks"]


def test_param_specs_are_the_ports_state_dict():
    """Names and shapes in the ``state_dict``'s order; the BatchNorms' step
    counters, which no forward reads, are the program's to add."""
    with torch.device("meta"):
        net = xcit_l12()
    want = [(k, tuple(v.shape)) for k, v in net.state_dict().items()
            if not k.endswith(".num_batches_tracked")]
    assert [(name, tuple(shape)) for name, shape, _ in reference.param_specs(CONFIG)] == want


def test_reference_agrees_with_the_port_at_the_small_size():
    """The benchmark's own weights of the tiny twin, drawn as a run draws
    them, through ``program.victim`` and through the reference: logits
    within 1e-5 of the largest and the CW input gradient within 1e-5 in
    relative l2 (fp32 rounding in other summation orders)."""
    cfg = dict(CONFIG, **TINY)
    params = inputs.weights(cfg, SEED, torch.device("cpu"))
    victim = program.victim(cfg, params, torch.device("cpu"))
    x = inputs.images(SEED, "agree", 2, 64, "cpu")
    out = []
    for fn in (victim, reference.model(params, cfg)):
        xt = x.clone().requires_grad_(True)
        logits = fn(xt)
        (grad,) = torch.autograd.grad(logits.logsumexp(-1).sum() - logits[:, 0].sum(), xt)
        out.append((logits.detach(), grad))
    (lg, gg), (lw, gw) = out
    assert float((lg - lw).abs().max() / lw.abs().max()) < 1e-5
    assert float(torch.linalg.vector_norm(gg - gw) / torch.linalg.vector_norm(gw)) < 1e-5


def test_stored_parameters_and_flops_per_image():
    """``count_flops.count``'s measure, on the meta device: the forward and
    the input-gradient backward of a batch of two, per image; the
    parameters are the port's, the BatchNorms' running statistics apart."""
    params = {name: torch.empty(shape, device="meta")
              for name, shape, _ in reference.param_specs(CONFIG)}
    buffers = sum(p.numel() for n, p in params.items()
                  if n.endswith(("running_mean", "running_var")))
    assert (buffers, CONFIG["buffers"]) == (21_312, 21_312)
    assert sum(p.numel() for p in params.values()) - buffers == CONFIG["parameters"] == 103_792_648
    with torch.device("meta"):
        assert sum(p.numel() for p in xcit_l12().parameters()) == CONFIG["parameters"]
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
    return SimpleNamespace(**reader("xcit_lpi_roofline").__globals__)


def test_roofline_arithmetic():
    mod = roofline_module()
    n = mod.elements(CONFIG)
    assert n == 196 * 768 * 12 == 1_806_336
    # Bound by bytes each way: 8 and 12 B an element at 3.35 TB/s.
    assert 64 * mod.pass_seconds(n, 36, grad=False) == pytest.approx(8 * 64 * n / 3.35e12)
    assert 64 * mod.pass_seconds(n, 36, grad=True) * 1e3 == pytest.approx(0.690, abs=5e-4)
    assert mod.least_seconds(CONFIG, [(64, True), (64, False)]) == pytest.approx(
        64 * (2 * mod.pass_seconds(n, 36, False) + 12 * n / 3.35e12))


def test_readers_on_fixed_device_totals(monkeypatch):
    totals = {"victim/xcit/xca": profiling.DeviceTotal(24, 0.01, 0.02),
              "victim/xcit/lpi": profiling.DeviceTotal(24, 0.004, 0.006),
              "victim/xcit/mlp": profiling.DeviceTotal(24, 0.03, 0.05)}
    monkeypatch.setattr(profiling, "device_totals", lambda: dict(totals))
    passes = [(64, False), (64, True)]
    ctx = SimpleNamespace(on_device=True, trace=SimpleNamespace(busy_s=0.2), config=CONFIG,
                          passes=passes)
    assert reader(METRICS[0])(ctx) == pytest.approx(15.0)
    assert reader(METRICS[1])(ctx) == pytest.approx(5.0)
    least = roofline_module().least_seconds(CONFIG, passes)
    assert reader(METRICS[2])(ctx) == pytest.approx(100.0 * least / 0.01)
    off = SimpleNamespace(on_device=False, trace=None, config=CONFIG, passes=passes)
    assert all(reader(n)(off) is None for n in METRICS)
    monkeypatch.setattr(profiling, "device_totals", dict)  # a victim without the spans
    assert all(reader(n)(ctx) is None for n in METRICS)
    monkeypatch.delattr(profiling, "device_totals")  # a program without the device clock
    assert all(reader(n)(ctx) is None for n in METRICS)


def test_reference_loads_nothing_of_the_port():
    script = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
              "from h100bench.reference import xcit\n"
              "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         check=True, timeout=300)
    assert not set(out.stdout.split()) & {"jax", "jaxlib", "flax", "dl_attack_on_imagenet_tpu",
                                          "dl_attack_on_imagenet_tpu_torch"}
