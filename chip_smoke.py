"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``dl_attack_on_imagenet_tpu_torch`` alone on the card, phase by
phase, and exits non-zero if any phase fails:

1. requires CUDA and prints the card's name and power limit;
2. builds every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, all started together) and prints what ``ptxas`` reports;
3. holds each kernel against its plain torch twin on the card;
4. checks the served path against the plain path on the CPU at a small size;
5. serves ADiL on ResNet-50 at 224x224, K=100 atoms, batch 64, eps 8/255
   l∞, CW loss: supervised DDrague, unsupervised best-of-trials sampling and
   supervised AdamW on the codes, each through the ``ADIL`` entry points,
   with seeded random weights and a seeded random dictionary; each mode is
   timed after a warm-up, then traced once with torch.profiler to print
   where its device time goes;
6. prints one ``{"kernels": [...]}`` line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Precision: matmuls and cuDNN convolutions both run in true fp32 here
(``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``); the dictionary contractions
refuse to run with matmul TF32 on, whatever the caller sets.
"""

from __future__ import annotations

import json
import subprocess
import tempfile
import time

import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores
EPS = 8 / 255


def _time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fused_perturb_bound_ms(n: int, k: int, m: int):
    """Least time for the function on an H100 SXM: each input read once and
    the output written once at the HBM rate, against its fp32 FMAs at the
    fp32 rate. Returns (ms, "bytes" | "operations")."""
    bytes_ms = 4 * (n * k + k * m + 2 * n * m) / H100_BYTES_PER_S * 1e3
    ops_ms = 2 * n * k * m / H100_FP32_FLOP_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_fused_perturb(dev) -> dict:
    """Kernel against its plain twin in four cases; timing at the serving shape."""
    from dl_attack_on_imagenet_tpu_torch.ops import fused_perturb, fused_perturb_reference

    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.rand(s, generator=g, device=dev)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    n, k, h = 64, 100, 224
    m = h * h * 3
    d4 = rand(k, h, h, 3) * 2 - 1
    x = rand(n, h, h, 3)
    v = randn(n, k) * 0.01
    ragged = (randn(5, 7) * 0.1, rand(7, 3 * 257) * 2 - 1, rand(5, 3 * 257))

    def plain(v_, d_, x_, eps):
        out = fused_perturb_reference(v_, d_.reshape(d_.shape[0], -1),
                                      x_.reshape(x_.shape[0], -1), eps)
        return out.reshape(x_.shape)

    cases = [
        ("N=64 K=100 M=150528, 4-D D, eps=8/255", (v, d4, x), EPS),
        ("ragged N=5 K=7 M=3*257", ragged, 0.05),
        ("eps=inf", (v, d4, x), float("inf")),
        ("codes x1000", (v * 1000, d4, x), EPS),
    ]
    max_err = 0.0
    for label, (cv, cd, cx), eps in cases:
        got = fused_perturb(cv, cd, cx, eps)
        want = plain(cv, cd, cx, eps)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"fused_perturb [{label}]: max_abs_err {err:.3e} (tol 1e-5)")
        if not err <= 1e-5:
            raise AssertionError(f"fused_perturb disagrees with its plain twin: {err}")
        if label == "codes x1000":
            lo, hi = float(got.min()), float(got.max())
            budget = float((got - cx.clamp(0, 1)).abs().max())
            print(f"  bounds: min {lo} max {hi} |adv - clip(x)|_inf {budget}")
            if not (lo >= 0 and hi <= 1 and budget <= eps + 1e-6):
                raise AssertionError("fused_perturb breaks its bounds")
        max_err = max(max_err, err)

    ms = _time_ms(lambda: fused_perturb(v, d4, x, EPS))
    plain_ms = _time_ms(lambda: plain(v, d4, x, EPS))
    bound_ms, bound_by = fused_perturb_bound_ms(n, k, m)
    print(f"fused_perturb at N={n} K={k} M={m}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); no single "
          "PyTorch call computes this function, so there is no library time")
    return {"name": "fused_perturb", "route": "cuda",
            "source": "dl_attack_on_imagenet_tpu_torch/csrc/fused_perturb.cu",
            "replaces": "dl_attack_on_imagenet_tpu/ops/pallas_kernels.py:75",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_small_against_cpu(dev) -> None:
    """The served path on the card against the plain path on the CPU, on the
    tiny victim at a small size (atol 1e-4 after 5 AdamW steps: cuDNN and
    the CPU sum in other orders; 1e-5 for sampling, which has no steps)."""
    from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
    from dl_attack_on_imagenet_tpu_torch.models import create_model

    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(1)
    victim_cpu = create_model("tiny", device=cpu, seed=1)
    victim_dev = create_model("tiny", device=dev, state_dict=victim_cpu.net.state_dict())
    d = torch.rand((8, 32, 32, 3), generator=g) * 2 - 1
    x = torch.rand((4, 32, 32, 3), generator=g)
    v_trials = torch.rand((3, 4, 8), generator=g) * 0.05
    cfg = core.AdilConfig(n_atoms=8, loss="logits", steps_inference=5, trials=3)
    runs = [
        ("ddrague", 1e-4, lambda vic, dd, xx, vt: core.supervised_ddrague(vic, dd, xx, cfg)),
        ("unsupervised", 1e-5, lambda vic, dd, xx, vt: core.unsupervised_sample(
            vic, dd, xx, None, cfg, v_trials=vt)),
    ]
    for name, tol, run in runs:
        want = run(victim_cpu, d, x, v_trials)
        got = run(victim_dev, d.to(dev), x.to(dev), v_trials.to(dev))
        torch.cuda.synchronize()
        err = float((got.cpu() - want).abs().max())
        print(f"small-size {name}: card vs CPU max_abs_err {err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"{name} on the card disagrees with the CPU: {err}")


def print_device_breakdown(mode: str, fn, wall_s: float, top: int = 5) -> None:
    """Trace one more run of ``fn`` with torch.profiler and print where the
    device time goes: the sum of kernel times against the untraced run's
    wall time (the busy share), and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total_ms = sum(ms for _, ms, _ in kernels)
    if total_ms <= 0:
        print(f"profile {mode}: the profiler traced no device time")
        return
    kernels.sort(key=lambda row: -row[1])
    perturb_ms = sum(ms for key, ms, _ in kernels if "fused_perturb" in key)
    print(f"profile {mode}: kernels {total_ms:.1f} ms on the device in a "
          f"{wall_s * 1e3:.1f} ms run (busy {total_ms / (wall_s * 1e3):.1%}); "
          f"fused_perturb {perturb_ms:.3f} ms ({perturb_ms / total_ms:.2%})")
    for key, ms, count in kernels[:top]:
        print(f"    {ms / total_ms:6.1%} {ms:9.2f} ms x{count:<5d} {key[:90]}")


def serve(dev) -> int:
    """ADiL serving on ResNet-50 through the ADIL entry points; returns the
    fused_perturb launches of the three timed runs."""
    from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
    from dl_attack_on_imagenet_tpu_torch.attacks.adil_core import AdilConfig, init_dictionary
    from dl_attack_on_imagenet_tpu_torch.evaluation import (
        compute_fooling_rate, compute_mse, compute_rmse)
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import fused_perturb, project_dictionary
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    n, k, size = 64, 100, 224
    victim = create_model("resnet50", device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(0)
    d = project_dictionary(init_dictionary(g, (size, size, 3), AdilConfig(n_atoms=k)))
    images = torch.rand((n, size, size, 3), generator=g, device=dev)
    total_launches = 0
    with tempfile.TemporaryDirectory() as root:
        cache = ArtifactCache(root)
        cache.save({"d": d}, "ImageNet", model="resnet50")
        for mode in ("supervised", "unsupervised", "supervised_adamw"):
            attack = ADIL(victim, eps=EPS, n_atoms=k, loss="logits",
                          steps_inference=30, trials=10, cache=cache,
                          attack="unsupervised" if mode == "unsupervised" else "supervised")
            run = attack.forward_supervised_adamw if mode == "supervised_adamw" else attack
            run(images)  # warm-up
            torch.cuda.synchronize()
            fused_perturb.launches = 0
            t0 = time.perf_counter()
            adv = run(images)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fused_perturb.launches
            total_launches += launches
            linf = float((adv - images).abs().max())
            clean = victim.predict(images)
            fool = compute_fooling_rate(victim, adv, None, "mean", clean_labels=clean)
            print(f"serve {mode}: wall {wall:.3f} s, fused_perturb launches {launches}, "
                  f"fooling rate {fool:.4f} ({clean.unique().numel()} distinct clean "
                  f"labels), mse {compute_mse(adv, images, 'mean'):.6f}, "
                  f"rmse {compute_rmse(adv, images, 'mean'):.6e}, |adv - x|_inf {linf:.6f}")
            if adv.shape != images.shape or not bool(torch.isfinite(adv).all()):
                raise AssertionError(f"{mode}: bad adversaries {tuple(adv.shape)}")
            if not (float(adv.min()) >= 0 and float(adv.max()) <= 1):
                raise AssertionError(f"{mode}: adversaries leave [0, 1]")
            if mode != "supervised" and not linf <= EPS + 1e-5:
                raise AssertionError(f"{mode}: l∞ budget broken: {linf} > {EPS}")
            if launches == 0:
                raise AssertionError(f"{mode}: fused_perturb was never launched")
            print_device_breakdown(mode, lambda: run(images), wall)
    return total_launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn allow_tf32={torch.backends.cudnn.allow_tf32}")

    from dl_attack_on_imagenet_tpu_torch.ops import native

    t0 = time.perf_counter()
    for name, out in native.build(native.SOURCES, ptxas_info=True).items():
        print(f"built {name} ({time.perf_counter() - t0:.1f} s)\n{out.strip()}")

    kernels = [check_fused_perturb(dev)]
    check_small_against_cpu(dev)
    kernels[0]["launches"] = serve(dev)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
