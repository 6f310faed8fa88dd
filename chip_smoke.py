"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``dl_attack_on_imagenet_tpu_torch`` alone on the card, phase by
phase, and exits non-zero if any phase fails:

1. requires CUDA and prints the card's name and power limit;
2. builds every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, all started together) and prints what ``ptxas`` reports;
3. holds each kernel against its plain torch twin on the card, and times
   it beside its bound, its twin and, where there is one, a PyTorch call;
   ``fused_perturb`` also cold (each launch after a 256 MiB write, as it
   runs after a ResNet-50 pass on the main path), with its rate, its share
   of the bound and its launch (grid, resident blocks, registers, spills),
   its time at N=128 (two row chunks a tile), and ``torch.addmm`` beside it
   for information;
4. checks the served path and three training steps against the plain path
   on the CPU at a small size;
5. serves ADiL on ResNet-50 at 224x224, K=100 atoms, batch 64, eps 8/255
   l∞, CW loss: supervised DDrague, unsupervised best-of-trials sampling and
   supervised AdamW on the codes, each through the ``ADIL`` entry points,
   with seeded random weights and a seeded random dictionary; each mode is
   timed after a warm-up, then traced once with torch.profiler to print
   where its device time goes and each kernel's time a launch in place;
6. trains ADiL at the same configuration: one warm-up step, then 10 steps
   chained on one batch of 64 (the step ``bench.py`` times), timed and then
   traced; then each ``learn_dictionary`` path through the ``ADIL``
   constructor on 128 images: ``gd`` resident for 2 epochs with a
   checkpoint after each, ``gd`` streamed from the host for 1 epoch, and
   ``alter`` for 1 round;
7. prints one ``{"kernels": [...]}`` line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Each path runs with the kernels' launch counts set to 0 just before it, and
fails if a kernel of that path was not launched as often as the path must.

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
    """Mean device time of ``fn`` over ``iters`` back-to-back launches, by
    one pair of CUDA events around them all (L2 warm from the last launch)."""
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


def _time_cold_ms(fn, iters: int = 50, warmup: int = 3, flush_bytes: int = 256 << 20) -> float:
    """Mean device time of ``fn`` with L2 cold: before each launch a
    ``flush_bytes`` scratch buffer (over five times an H100's 50 MB L2) is
    written, and each launch is timed by its own pair of CUDA events."""
    scratch = torch.empty(flush_bytes // 4, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for i in range(iters):
        scratch.fill_(float(i))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _bound(bytes_moved: float, flops: float):
    """(ms, "bytes" | "operations"): the larger of the HBM time of the bytes
    and the fp32 time of the operations on an H100 SXM."""
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = flops / H100_FP32_FLOP_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def fused_perturb_bytes(n: int, k: int, m: int) -> int:
    """Bytes the function must move: v, D and x read once, out written once."""
    return 4 * (n * k + k * m + 2 * n * m)


def fused_perturb_bound_ms(n: int, k: int, m: int):
    """Least time for the function on an H100 SXM: each input read once and
    the output written once at the HBM rate, against its fp32 FMAs at the
    fp32 rate. Returns (ms, "bytes" | "operations")."""
    return _bound(fused_perturb_bytes(n, k, m), 2 * n * k * m)


def fused_adamw_project_bound_ms(n: int):
    """Least time for one AdamW step and clamp over n fp32 elements: read p,
    g, mu, nu and write p, mu, nu once, against 17 operations an element
    (7 for the moments, 4 for the update, 4 for the step, 2 for the clamp)."""
    return _bound(7 * 4 * n, 17 * n)


def check_fused_perturb(dev) -> dict:
    """Kernel against its plain twin in four cases; timing at the serving shape."""
    from dl_attack_on_imagenet_tpu_torch.ops import fused_perturb, fused_perturb_reference
    from dl_attack_on_imagenet_tpu_torch.ops.kernels import fused_perturb_launch_info

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
    cold = _time_cold_ms(lambda: fused_perturb(v, d4, x, EPS))
    plain_ms = _time_ms(lambda: plain(v, d4, x, EPS))
    bound_ms, bound_by = fused_perturb_bound_ms(n, k, m)
    moved = fused_perturb_bytes(n, k, m)
    info = fused_perturb_launch_info(n, m)
    print(f"fused_perturb at N={n} K={k} M={m}: kernel {ms:.4f} ms warm (50 "
          f"back-to-back), {cold:.4f} ms cold (each launch after a 256 MiB "
          f"write), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); no single PyTorch call computes "
          "this function, so there is no library time")
    print(f"  achieved {moved / ms / 1e9:.3f} TB/s warm ({bound_ms / ms:.1%} of "
          f"the bound), {moved / cold / 1e9:.3f} TB/s cold ({bound_ms / cold:.1%})")
    print(f"  launch: grid {info['grid']} blocks of {info['threads']} threads "
          f"({info['blocks_per_sm']} resident a SM x {info['sms']} SMs, "
          f"{info['grid'] / (info['blocks_per_sm'] * info['sms']):.2f} waves), "
          f"{info['items']} work items of 64 x {info['cols']} "
          f"({info['items'] / info['grid']:.2f} a block), {info['atoms']} atoms x "
          f"{info['stages']} stages, {info['smem_bytes']} B shared memory, "
          f"{info['registers']} registers, {info['spill_bytes']} spill bytes a "
          f"thread, 16-byte path {bool(info['vec'])}")
    if info["spill_bytes"]:
        raise AssertionError("fused_perturb spills registers")
    v2, x2 = randn(2 * n, k) * 0.01, rand(2 * n, h, h, 3)
    ms2 = _time_ms(lambda: fused_perturb(v2, d4, x2, EPS))
    bound2, _ = fused_perturb_bound_ms(2 * n, k, m)
    print(f"  at N={2 * n} (two 64-row chunks a tile, D read again for the second): "
          f"{ms2:.4f} ms warm, {ms2 / ms:.2f}x N={n} for "
          f"{fused_perturb_bytes(2 * n, k, m) / moved:.2f}x the bytes; bound {bound2:.4f} ms")
    d2 = d4.reshape(k, m)
    addmm_ms = _time_ms(lambda: torch.addmm(x.reshape(n, m), v, d2))
    print(f"  informative: torch.addmm(x, v, D) in fp32 {addmm_ms:.4f} ms (cuBLAS "
          "product and add, not the same function: no clamps)")
    return {"name": "fused_perturb", "route": "cuda",
            "source": "dl_attack_on_imagenet_tpu_torch/csrc/fused_perturb.cu",
            "replaces": "dl_attack_on_imagenet_tpu/ops/pallas_kernels.py:75",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "bound_share": bound_ms / ms}


def check_fused_adamw_project(dev) -> dict:
    """Kernel against its plain twin at the dictionary's size (steps 1, 2 and
    100, clamp 1 and none), then times: the kernel, the twin, and torch's
    fused AdamW step followed by the clamp as the library yardstick."""
    from dl_attack_on_imagenet_tpu_torch.ops import (
        fused_adamw_project, fused_adamw_project_reference)

    n = 100 * 224 * 224 * 3
    g = torch.Generator(device=dev).manual_seed(3)

    def inputs():
        return (torch.rand((n,), generator=g, device=dev) * 2.4 - 1.2,
                torch.randn((n,), generator=g, device=dev),
                torch.randn((n,), generator=g, device=dev) * 0.1,
                torch.rand((n,), generator=g, device=dev) * 0.01)

    max_err = 0.0
    for step in (1, 2, 100):
        for clip in (1.0, float("inf")):
            p, grad, mu, nu = inputs()
            want = fused_adamw_project_reference(p, grad, mu, nu, step, 0.01, clip_val=clip)
            fused_adamw_project(p, grad, mu, nu, step, 0.01, clip)
            torch.cuda.synchronize()
            errs = [float((p - want[0]).abs().max()), float((mu - want[1]).abs().max()),
                    float(((nu - want[2]).abs() / want[2].abs().clamp(min=1e-30)).max())]
            print(f"fused_adamw_project [n={n} step={step} clip={clip}]: max_abs_err p "
                  f"{errs[0]:.3e} mu {errs[1]:.3e}, nu max_rel_err {errs[2]:.3e} (tol 1e-6)")
            if not max(errs) <= 1e-6:
                raise AssertionError(f"fused_adamw_project disagrees with its twin: {errs}")
            max_err = max(max_err, errs[0], errs[1])

    p, grad, mu, nu = inputs()
    ms = _time_ms(lambda: fused_adamw_project(p, grad, mu, nu, 2, 0.01, 1.0))
    plain_ms = _time_ms(lambda: fused_adamw_project_reference(p, grad, mu, nu, 2, 0.01))
    lib_p = p.clone().requires_grad_(True)
    lib_p.grad = grad
    opt = torch.optim.AdamW([lib_p], lr=0.01, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-2, fused=True)

    def library():
        opt.step()
        with torch.no_grad():
            lib_p.clamp_(-1.0, 1.0)

    library_ms = _time_ms(library)
    bound_ms, bound_by = fused_adamw_project_bound_ms(n)
    print(f"fused_adamw_project at n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), library {library_ms:.4f} ms (two calls: "
          "torch.optim.AdamW(fused=True).step() then clamp_)")
    return {"name": "fused_adamw_project", "route": "cuda",
            "source": "dl_attack_on_imagenet_tpu_torch/csrc/fused_adamw_project.cu",
            "replaces": "dl_attack_on_imagenet_tpu/ops/pallas_kernels.py:164",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "bound_share": bound_ms / ms}


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


def check_train_small_against_cpu(dev) -> None:
    """Three joint training steps on the card against the CPU on the tiny
    victim (atol 1e-4: cuDNN sums in another order than the CPU, and AdamW
    divides by small second moments)."""
    from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
    from dl_attack_on_imagenet_tpu_torch.models import create_model

    cpu = torch.device("cpu")
    victim_cpu = create_model("tiny", device=cpu, seed=1)
    victim_dev = create_model("tiny", device=dev, state_dict=victim_cpu.net.state_dict())
    cfg = core.AdilConfig(n_atoms=8, loss="logits")
    g = torch.Generator().manual_seed(2)
    images = torch.rand((6, 32, 32, 3), generator=g)
    state_cpu = core.init_state(g, (32, 32, 3), 6, cfg)
    state_dev = core.TrainState(**{k: (v.to(dev) if torch.is_tensor(v) else v)
                                   for k, v in vars(state_cpu).items()})
    labels = core.predict_labels(victim_cpu, images)
    idx, mask = torch.tensor([3, 0, 5, 0]), torch.tensor([1.0, 1.0, 1.0, 0.0])
    losses = []
    for state, victim, d in ((state_cpu, victim_cpu, cpu), (state_dev, victim_dev, dev)):
        step = core.make_train_step(victim, cfg, "both")
        losses.append([float(step(state, images[idx].to(d), labels[idx].to(d),
                                  idx.to(d), mask.to(d))[0]) for _ in range(3)])
    torch.cuda.synchronize()
    err = max(float((state_dev.d.cpu() - state_cpu.d).abs().max()),
              float((state_dev.v.cpu() - state_cpu.v).abs().max()),
              max(abs(a - b) for a, b in zip(*losses)))
    print(f"small-size training: 3 steps, card vs CPU max_abs_err {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"training on the card disagrees with the CPU: {err}")


def print_device_breakdown(mode: str, fn, wall_s: float, top: int = 5) -> None:
    """Trace one more run of ``fn`` with torch.profiler and print where the
    device time goes: the sum of kernel times against the untraced run's
    wall time (the busy share), each of the port's kernels with its time a
    launch in place (profiler time / launches), and the kernels that take
    most of it."""
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
    ours = []
    for name in ("fused_perturb", "fused_adamw_project"):
        ms = sum(ms for key, ms, _ in kernels if name in key)
        count = sum(c for key, _, c in kernels if name in key)
        each = f", {ms / count:.4f} ms a launch in place x{count}" if count else ""
        ours.append(f"{name} {ms:.3f} ms ({ms / total_ms:.2%}{each})")
    ours = "; ".join(ours)
    print(f"profile {mode}: kernels {total_ms:.1f} ms on the device in a "
          f"{wall_s * 1e3:.1f} ms run (busy {total_ms / (wall_s * 1e3):.1%}); {ours}")
    for key, ms, count in kernels[:top]:
        print(f"    {ms / total_ms:6.1%} {ms:9.2f} ms x{count:<5d} {key[:90]}")


def _zero_counts() -> None:
    """Set every kernel's launch count to 0, just before a path runs."""
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project, fused_perturb

    fused_perturb.launches = fused_adamw_project.launches = 0


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
            _zero_counts()
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


def _check_trained(name: str, d, v, eps: float) -> None:
    """D inside [-1, 1] and each code row inside the eps l1 ball, finite."""
    d_max = float(d.abs().max())
    v_l1 = float(v.abs().sum(1).max())
    print(f"  {name}: |D|_max {d_max:.6f}, max row |v|_1 {v_l1:.6f} (eps {eps:.6f})")
    if not (torch.isfinite(d).all() and torch.isfinite(v).all()):
        raise AssertionError(f"{name}: non-finite state")
    if not (d_max <= 1.0 and v_l1 <= eps + 1e-6):
        raise AssertionError(f"{name}: D or v left its constraint set")


def train(dev, model: str = "resnet50", size: int = 224, n: int = 64, k: int = 100) -> int:
    """ADiL training on ResNet-50, the step bench.py times: a warm-up step,
    then 10 steps chained on one batch, timed and then traced. Returns the
    fused_adamw_project launches of the timed run. (The keyword arguments
    shrink the run for a rehearsal on the CPU.)"""
    from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project

    n_steps = 10
    victim = create_model(model, device=dev, seed=0)
    cfg = core.AdilConfig(eps=EPS, norm="linf", n_atoms=k, loss="logits", kappa=50.0,
                          step_size=0.01, batch_size=n)
    g = torch.Generator(device=dev).manual_seed(1)
    images = torch.rand((n, size, size, 3), generator=g, device=dev)
    state = core.init_state(g, (size, size, 3), n, cfg)
    labels = core.predict_labels(victim, images)
    idx = torch.arange(n, device=dev)
    mask = torch.ones(n, device=dev)
    step = core.make_train_step(victim, cfg, "both")
    step(state, images, labels, idx, mask)  # warm-up
    scan = core.make_train_scan(victim, cfg, "both", n_steps=n_steps)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses, foolings = scan(state, images, labels, idx, mask)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_adamw_project.launches
    print(f"train gd step on {model} at b{n} K={k} {size}x{size}: {wall / n_steps * 1e3:.2f} ms/step, "
          f"{n_steps / wall:.2f} it/s over {n_steps} chained steps, fused_adamw_project "
          f"launches {launches}; loss {losses[0]:.4f} -> {losses[-1]:.4f}, fooling "
          f"{int(foolings[-1])}/{n}")
    if launches != 2 * n_steps:
        raise AssertionError(f"train: {launches} launches in {n_steps} steps, not 2 a step")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("train: non-finite loss")
    _check_trained("train", state.d, state.v, EPS)
    print_device_breakdown("train step", lambda: step(state, images, labels, idx, mask),
                           wall / n_steps)
    return launches


def learn_entry_points(dev, model: str = "resnet50", size: int = 224, n: int = 128,
                       b: int = 64, k: int = 100) -> int:
    """Each learn_dictionary path through the ADIL constructor on 128 images
    at the training configuration. Returns the fused_adamw_project launches
    of the three runs."""
    import numpy as np

    from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    victim = create_model(model, device=dev, seed=0)
    rs = np.random.default_rng(2)
    data = (rs.random((n, size, size, 3), dtype=np.float32), np.zeros((n,), np.int64))
    runs = [  # (name, ADIL options, launches the path must make)
        ("gd resident, 2 epochs", dict(steps=2, stream=False), 2 * 2 * (n // b)),
        ("gd streamed, 1 epoch", dict(steps=1, stream=True), 2 * (n // b)),
        ("alter, 1 round", dict(steps=1, method="alter"), 2 * (n // b)),
    ]
    total = 0
    for name, options, want in runs:
        with tempfile.TemporaryDirectory() as root:
            cache = ArtifactCache(root)
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            attack = ADIL(victim, eps=EPS, n_atoms=k, batch_size=b, loss="logits",
                          data_train=data, cache=cache, checkpoint_every=1, seed=0,
                          **options)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fused_adamw_project.launches
            history = attack.history["loss"]
            print(f"learn_dictionary {name}: wall {wall:.2f} s, fused_adamw_project "
                  f"launches {launches}, loss {history}, fooling "
                  f"{attack.history['fooling_rate']}, timing {attack.timing}")
            if launches != want:
                raise AssertionError(f"{name}: {launches} launches, the path makes {want}")
            if not (history and all(np.isfinite(history))):
                raise AssertionError(f"{name}: bad loss history {history}")
            saved = cache.load("ImageNet", model=victim.name)
            if saved is None or saved["d"].shape != (k, size, size, 3):
                raise AssertionError(f"{name}: no artifact of the right shape")
            if cache.exists("ImageNet", model=victim.name, kind="train_state_torch"):
                raise AssertionError(f"{name}: the train state was not cleared")
            _check_trained(name, torch.as_tensor(saved["d"]), torch.as_tensor(saved["v"]), EPS)
            total += launches
    return total


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

    kernels = [check_fused_perturb(dev), check_fused_adamw_project(dev)]
    check_small_against_cpu(dev)
    check_train_small_against_cpu(dev)
    kernels[0]["launches"] = serve(dev)
    kernels[1]["launches"] = train(dev) + learn_entry_points(dev)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
