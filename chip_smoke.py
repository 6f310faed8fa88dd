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
   on the CPU at a small size, and every victim family's logits and CW input
   gradient on the card against the CPU at a small input size (DenseNet-121
   and GoogLeNet also with their space-to-depth stems);
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
7. serves one batch of 64 on each other victim of the zoo at full width and
   depth (DenseNet-169, GoogLeNet, Inception-v3, VGG-16, ViT-B/16 at
   224x224; supervised DDrague cut to 5 steps and 5 unsupervised trials),
   timed and traced like phase 5; then holds ``fused_perturb`` against its
   twin at Inception's native 299x299 (M = 268203, odd: the kernel's scalar
   instance) and serves one Inception batch there;
8. runs the experiment of ``cli.demo`` through ``run_experiment`` on its
   default victim, DenseNet-121, at 224x224 (K=100, 2 epochs of 64 images,
   val and test of 2 and 5 images, 100 DDrague steps a served batch), then
   the single-image attack of ``cli.main`` on its default victim,
   MobileNetV2, with the dictionary that run saved, and prints each stage's
   wall, the metrics and the results file;
9. runs the bf16 mixed precision (``perturb_dtype="bfloat16"``) on
   ResNet-50 beside fp32 at the training and serving configuration: 10
   chained ``gd`` steps after a warm-up, a supervised DDrague batch and a
   supervised AdamW-codes batch of 64, each timed in both precisions after
   a warm-up at the JAX package's own 5 solver steps, the bf16 losses
   within rtol 0.02 of fp32's, the 5-step adversaries within 0.05 of
   fp32's, every adversary in [0, 1] (AdamW's inside eps + 1e-5), the
   master state fp32 and the same launches as fp32;
10. learns data-parallel at world size 1 over NCCL: ``ADIL(mesh=data_mesh())``
   on ResNet-50 at 224x224, 128 seeded images, b64, 2 epochs with a
   checkpoint after each, ``check_mesh`` first; D and v within 1e-5 of the
   serial replay of the same plan (``make_dp_replay_epoch_fn``), both under
   deterministic cuDNN, and the replay's spread without it, the sharded
   accuracy equal to the unsharded one, 2 ``fused_adamw_project`` launches
   a step;
11. learns data-parallel at 2 ranks on the one card over gloo (NCCL puts no
   two ranks on one card): two spawned ranks (``chip_smoke.py --dp-rank R
   DIR DEVICE``) on the tiny victim at 32x32, K=100, 32 images, b16, 2
   epochs, both on ``cuda:0``; both ranks' D and v identical, and within
   1e-5 of the replay on the card; then each rank learns again with
   ``ckpt_sharded=True`` (the collective ``torch.distributed.checkpoint``
   save), killed just after its first checkpoint and resumed, equal to its
   first run bit for bit, with the save and restore walls and the bytes;
   then, at world size 1 over NCCL, learns with ``ckpt_sharded=True`` on
   ResNet-50 at 224x224, K=100, 128 images, b64, 2 epochs with a checkpoint
   after each: whole, and killed just after its first checkpoint and
   resumed (deterministic cuDNN), D, v and the history bit-equal, with each
   save's and the restore's wall and the directory's bytes beside the
   card's name and power limit; and in both DP settings, v and its
   moments at the full ImageNet train set's 1,281,167 x 100 rows (1.5 GB)
   through both checkpoints, the sharded one and the rank-0 gather and
   msgpack file, each timed and restored bit-equal;
12. runs the experiment of phase 8 once more with ``--distributed
   --mixed-precision``;
13. runs the universal baselines on ResNet-50 at 224x224 at the JAX
   package's operating points: UAP-PGD learning (256 images, b64, l2 eps
   0.1, Adam; ms/epoch after a warm-up epoch, one traced epoch), serving a
   batch of 64, and learning data-parallel at world size 1 over NCCL
   against its serial replay (1e-5, deterministic cuDNN); DeepFool and
   DeepFoolCosinus on a batch of 16 (10 classes, 10 iterations; DeepFool
   traced); Fast-UAP and Moosavi's universal perturbation on 16 images
   with 16 for val (chunk 1), with their DeepFool solves counted; the
   harness's lazy ``learn_attack`` and the transfer of the learned UAP onto
   ResNet-50 and DenseNet-121; DeepFool and a UAP-PGD epoch on the card
   against the CPU on the tiny victim; and no launch of either kernel;
14. runs the reference's torchattacks grid on ResNet-50 at 224x224, batch
   64, eps 8/255 and alpha 2/255 (the classifier tempered): VANILA, GN, the
   FGSM family, PGD and BIM, CW, APGD-CE and APGD-T, FAB and FAB-T, Square,
   OnePixel and AutoAttack at cut depths (5 steps; 100 Square queries, 50
   in AutoAttack),
   each timed after a warm-up with its fooled share and largest l∞
   distance, inside [0, 1] and, where the budget is fixed, inside eps; PGD
   and Square traced; every family on the card against the CPU on the tiny
   victim with the same draws (1e-4, equal decisions); and no launch of
   either kernel;
15. runs ADILR on ResNet-50 at 224x224 at its own defaults (K=10, lambda_l1 =
   lambda_l2 = 0.1, budget 10/255, targeted CE, 100 trials; the classifier
   tempered where CE saturates): learning through the constructor in each
   version (``deterministic`` on 64 images with ``steps`` cut to 10,
   ``adamw`` on 128 at b64 for 2 epochs with 16 val images, ``sadil_updated``
   on 64 at b16 for 1 epoch), serving a batch of 64 supervised (one
   ``fused_perturb`` launch at the budget) and in each of the four
   unsupervised modes (one launch a trial), timed after a warm-up, one of
   each traced; both kernels at ADILR's shapes against their twins and
   timed beside their bounds (``fused_adamw_project`` also beside
   ``torch.optim.AdamW(fused=True)``); and ADILR on the card against the CPU
   on the tiny victim;
16. holds ``fused_perturb`` against its twin at N=128 (``cli.generate``'s
   batch) and both kernels on the space-to-depth column order, each timed
   beside its twin and its bound;
17. runs ``cli.generate`` through its ``main`` on ResNet-50 at 224x224 with a
   seeded K=100 dictionary: a blob of 300 seeded images written by
   ``cli.dataset``'s writer (batches of 128, 128 and 44), served supervised
   (30 DDrague steps), unsupervised (10 trials) and with ``--save-images
   --limit 128``, then a folder of 8 JPEGs that the phase writes (PIL
   decodes them where the native loader does not build), printing each
   batch's wall, images/s, fooling rate and the launches (1 and 10 a
   batch), and one traced batch's busy share; then ``cli.import_artifacts``
   on reference-format ``torch.save`` files (ADIL's ``[d (3,224,224,100),
   v, ...]``, UAP-PGD's ``[e (1,3,224,224), ...]``) and one supervised
   batch of 64 served from the imported dictionary;
18. runs the space-to-depth layout on ResNet-50 with an S2D stem: the stem,
   the ``--fast-victim`` build and the blocked twin against the plain stem
   and the CPU (logits and CW input gradient, 1e-4); 10 chained ``gd``
   steps at b64 blocked beside standard, timed and traced, and 3 under
   deterministic cuDNN held against each other; a supervised DDrague
   batch of 64 through the twin beside the standard layout; ``ADIL``
   learning with ``pipeline_epochs`` True beside False (128 images, b64,
   2 epochs; D and v within 1e-5); and data-parallel learning at world
   size 1 with ``blocked=True`` against its serial replay on the twin;
19. runs one ``cli.generate`` batch inside ``utils.trace`` and checks that
   the trace file holds CUDA kernels;
20. runs a bf16 victim (``create_model(dtype=torch.bfloat16)``) beside the
   fp32 one on ResNet-50 at 224x224: 10 chained ``gd`` steps at b64 K=100,
   a supervised DDrague batch of 64 (30 steps) and a supervised AdamW-codes
   batch through ``ADIL``, one ``cli.generate`` supervised batch of 128,
   then ``bench.py``'s configuration (bf16, the S2D stem on blocked input,
   BatchNorms folded: the step and DDrague through the twin), each with its
   wall, launches and fooled share, the step and DDrague traced for their
   busy share; every tensor handed to a kernel on that path must be fp32;
   then every family's bf16 victim on the card against the CPU at a small
   size by the gap rule of the CPU tests (the card's bf16 logits and CW
   input gradient no further from the CPU's bf16 ones than those are from
   the CPU's fp32 ones, in relative l2);
21. runs the ``gd`` step on ResNet-50 at b64 under each ``ADIL_MAXPOOL`` x
   ``ADIL_RELU`` backward variant (``models.layers.POOL_MODE`` and
   ``RELU_MODE``): ms a step, peak memory, and the input gradient's largest
   gap from the default under deterministic cuDNN (0 but under ``slices``
   and ``vjp``);
22. prints the whole run's time and one ``{"kernels": [...]}`` line, each
   kernel's ADILR shape under ``"adilr"``, ``fused_perturb`` at N=128 under
   ``"n128"`` and both kernels on the blocked layout under ``"blocked"``,
   then the result line ``{"ok": true, "device": {...}}`` last.

Each path runs with the kernels' launch counts set to 0 just before it, and
fails if a kernel of that path was not launched as often as the path must.

Precision: matmuls and cuDNN convolutions both run in true fp32 here
(``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``), and bf16 products sum in fp32
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
False``); the dictionary contractions refuse to run otherwise.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores
EPS = 8 / 255
# Every victim family but the ResNets at a small input size, for the card
# against the CPU: (registry name, input size).
SMALL_FAMILIES = (("densenet121", 32), ("mobilenet_v2", 32), ("googlenet", 32),
                  ("inception_v3", 75), ("vgg11", 32), ("vit_tiny", 32))
# The families with a space-to-depth stem beside the ResNets, built with it
# for the same check.
SMALL_S2D = (("densenet121", 32), ("googlenet", 32))
# The zoo phase's victims beside the main path's ResNet-50, DenseNet-121
# and MobileNetV2.
ZOO = ("densenet169", "googlenet", "inception_v3", "vgg16", "vit_b16")
# The card's name and power limit as nvidia-smi gives them, set by main and
# printed beside the sharded checkpoint's walls.
CARD = "no card"


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


def _time_device_ms(fn, iters: int = 50, warmup: int = 5, sleep_cycles: int = 100_000_000):
    """Mean device time of ``fn`` over ``iters`` launches with the host
    ahead: the card first spins for ``sleep_cycles`` (about 50 ms), during
    which the host enqueues every launch, so no launch waits on the host's
    wrapper. Returns (ms, the host's enqueue time of the launches in ms),
    and raises if the host did not finish enqueueing within the spin."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin_start = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    spin_start.record()
    torch.cuda._sleep(sleep_cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= spin_start.elapsed_time(start):
        raise AssertionError(f"the host took {host_ms:.2f} ms to enqueue, longer than the spin")
    return start.elapsed_time(end) / iters, host_ms / iters


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
    """Kernel against its plain twin in four cases and at the CLI path's
    batch sizes; timing at the serving shape."""
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
    # The CLI path's batches: cli.main serves 1 image, the demo's val and test
    # 2 and 5, all on the 16-byte path with fewer than 64 rows live.
    for rows in (1, 2, 5):
        served = (randn(rows, k) * 0.01, d4, rand(rows, h, h, 3))
        vec = bool(fused_perturb_launch_info(rows, m)["vec"])
        cases += [(f"N={rows} K=100 M=150528, 4-D D, eps={name}, 16-byte path {vec}", served, eps)
                  for name, eps in (("8/255", EPS), ("inf", float("inf")))]
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
    """Kernel against its plain twin at the dictionary's size and at the
    codes' (64 x 100, the demo's training rows; steps 1, 2 and 100, clamp 1
    and none), then times at the dictionary's size: the kernel, the twin,
    and torch's fused AdamW step followed by the clamp as the library
    yardstick."""
    from dl_attack_on_imagenet_tpu_torch.ops import (
        fused_adamw_project, fused_adamw_project_reference)

    n = 100 * 224 * 224 * 3
    g = torch.Generator(device=dev).manual_seed(3)

    def inputs(shape=(n,)):
        return (torch.rand(shape, generator=g, device=dev) * 2.4 - 1.2,
                torch.randn(shape, generator=g, device=dev),
                torch.randn(shape, generator=g, device=dev) * 0.1,
                torch.rand(shape, generator=g, device=dev) * 0.01)

    max_err = 0.0
    for shape in ((n,), (64, 100)):
        for step in (1, 2, 100):
            for clip in (1.0, float("inf")):
                p, grad, mu, nu = inputs(shape)
                want = fused_adamw_project_reference(p, grad, mu, nu, step, 0.01, clip_val=clip)
                fused_adamw_project(p, grad, mu, nu, step, 0.01, clip)
                torch.cuda.synchronize()
                errs = [float((p - want[0]).abs().max()), float((mu - want[1]).abs().max()),
                        float(((nu - want[2]).abs() / want[2].abs().clamp(min=1e-30)).max())]
                print(f"fused_adamw_project [{'x'.join(map(str, shape))} step={step} "
                      f"clip={clip}]: max_abs_err p {errs[0]:.3e} mu {errs[1]:.3e}, nu "
                      f"max_rel_err {errs[2]:.3e} (tol 1e-6)")
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


def check_families_against_cpu(dev) -> None:
    """Each victim family on the card against the same victim on the CPU at
    a small input size, batch 2: logits and the CW-loss input gradient
    within 1e-4 (cuDNN's depthwise, grouped and padded-pool kernels and the
    CPU sum in other orders)."""
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import attack_loss

    g = torch.Generator().manual_seed(3)
    labels = torch.tensor([1, 3])
    builds = ([(name, size, {}) for name, size in SMALL_FAMILIES]
              + [(name, size, {"stem_s2d": True}) for name, size in SMALL_S2D])
    for name, size, kwargs in builds:
        victim_cpu = create_model(name, input_size=size, device="cpu", seed=1, **kwargs)
        victim_dev = create_model(name, input_size=size, device=dev,
                                  state_dict=victim_cpu.net.state_dict(), **kwargs)
        name = name + (" stem_s2d" if kwargs else "")
        x = torch.rand((2, size, size, 3), generator=g)
        out = []
        for victim, d in ((victim_cpu, torch.device("cpu")), (victim_dev, dev)):
            xt = x.to(d).requires_grad_(True)
            logits = victim(xt)
            (grad,) = torch.autograd.grad(attack_loss(logits, labels.to(d), loss="logits"), xt)
            out.append((logits.detach().cpu(), grad.cpu()))
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(*out)]
        print(f"small-size {name} at {size}x{size}: card vs CPU max_abs_err logits "
              f"{errs[0]:.3e}, CW input gradient {errs[1]:.3e} (tol 1e-4; |logits| up to "
              f"{float(out[0][0].abs().max()):.3e}, |gradient| up to "
              f"{float(out[0][1].abs().max()):.3e})")
        if not max(errs) <= 1e-4:
            raise AssertionError(f"{name} on the card disagrees with the CPU: {errs}")


def print_device_breakdown(mode: str, fn, wall_s: float, top: int = 5) -> None:
    """Trace one more run of ``fn`` with torch.profiler and print where the
    device time goes: the sum of kernel times against the untraced run's
    wall time (the busy share), each of the port's kernels with its time a
    launch in place (profiler time / launches), and the kernels that take
    most of it. Only the device is traced: recording the host's operators
    too gave the same kernel sums on a DenseNet-169 run of 0.87 s but took
    30 s to trace and read against 9 s."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def _serve_mode(run, images, victim, label: str, budget: bool) -> int:
    """One served mode: a warm-up run, a timed run with the launch count set
    to 0 before it, its checks (finite adversaries of the images' shape in
    [0, 1], inside the l∞ budget where ``budget``, at least one
    ``fused_perturb`` launch), then a traced run. Returns the timed run's
    ``fused_perturb`` launches."""
    from dl_attack_on_imagenet_tpu_torch.evaluation import (
        compute_fooling_rate, compute_mse, compute_rmse)
    from dl_attack_on_imagenet_tpu_torch.ops import fused_perturb

    t0 = time.perf_counter()
    run(images)  # warm-up
    torch.cuda.synchronize()
    warm_up = time.perf_counter() - t0
    _zero_counts()
    t0 = time.perf_counter()
    adv = run(images)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_perturb.launches
    linf = float((adv - images).abs().max())
    clean = victim.predict(images)
    fool = compute_fooling_rate(victim, adv, None, "mean", clean_labels=clean)
    print(f"serve {label}: wall {wall:.3f} s (warm-up {warm_up:.3f} s), fused_perturb launches {launches}, "
          f"fooling rate {fool:.4f} ({clean.unique().numel()} distinct clean "
          f"labels), mse {compute_mse(adv, images, 'mean'):.6f}, "
          f"rmse {compute_rmse(adv, images, 'mean'):.6e}, |adv - x|_inf {linf:.6f}")
    if adv.shape != images.shape or not bool(torch.isfinite(adv).all()):
        raise AssertionError(f"{label}: bad adversaries {tuple(adv.shape)}")
    if not (float(adv.min()) >= 0 and float(adv.max()) <= 1):
        raise AssertionError(f"{label}: adversaries leave [0, 1]")
    if budget and not linf <= EPS + 1e-5:
        raise AssertionError(f"{label}: l∞ budget broken: {linf} > {EPS}")
    if launches == 0:
        raise AssertionError(f"{label}: fused_perturb was never launched")
    t0 = time.perf_counter()
    print_device_breakdown(label, lambda: run(images), wall)
    print(f"  traced run and its breakdown: {time.perf_counter() - t0:.1f} s")
    return launches


def _served_inputs(dev, name: str, size: int, cache, n: int = 64, k: int = 100):
    """The seed-0 victim ``name`` at ``size``, a seeded projected random
    dictionary of ``k`` atoms saved for it in ``cache``, and ``n`` seeded
    U(0, 1) images."""
    from dl_attack_on_imagenet_tpu_torch.attacks.adil_core import AdilConfig, init_dictionary
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import project_dictionary

    victim = create_model(name, input_size=size, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(0)
    d = project_dictionary(init_dictionary(g, (size, size, 3), AdilConfig(n_atoms=k)))
    cache.save({"d": d}, "ImageNet", model=name)
    return victim, torch.rand((n, size, size, 3), generator=g, device=dev)


def serve(dev) -> int:
    """ADiL serving on ResNet-50 through the ADIL entry points; returns the
    fused_perturb launches of the three timed runs."""
    from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    k = 100
    total_launches = 0
    with tempfile.TemporaryDirectory() as root:
        cache = ArtifactCache(root)
        victim, images = _served_inputs(dev, "resnet50", 224, cache, k=k)
        for mode in ("supervised", "unsupervised", "supervised_adamw"):
            attack = ADIL(victim, eps=EPS, n_atoms=k, loss="logits",
                          steps_inference=30, trials=10, cache=cache,
                          attack="unsupervised" if mode == "unsupervised" else "supervised")
            run = attack.forward_supervised_adamw if mode == "supervised_adamw" else attack
            total_launches += _serve_mode(run, images, victim, mode, mode != "supervised")
    return total_launches


def check_fused_perturb_inception(dev, size: int = 299) -> float:
    """``fused_perturb`` against its twin at Inception-v3's native 299x299
    (M = 268203, odd, so the kernel's scalar instance runs) at n = 64 and 5,
    K = 100; returns the largest error (tolerance 1e-5)."""
    from dl_attack_on_imagenet_tpu_torch.ops import fused_perturb, fused_perturb_reference
    from dl_attack_on_imagenet_tpu_torch.ops.kernels import fused_perturb_launch_info

    g = torch.Generator(device=dev).manual_seed(4)
    k, m = 100, size * size * 3
    d = torch.rand((k, m), generator=g, device=dev) * 2 - 1
    max_err = 0.0
    for n in (64, 5):
        v = torch.randn((n, k), generator=g, device=dev) * 0.01
        x = torch.rand((n, m), generator=g, device=dev)
        vec = bool(fused_perturb_launch_info(n, m)["vec"])
        for eps in (EPS, float("inf")):
            err = float((fused_perturb(v, d, x, eps) - fused_perturb_reference(v, d, x, eps))
                        .abs().max())
            print(f"fused_perturb [N={n} K={k} M={m} (Inception at {size}x{size}), eps={eps:.6f}, "
                  f"16-byte path {vec}]: max_abs_err {err:.3e} (tol 1e-5)")
            if not err <= 1e-5:
                raise AssertionError(f"fused_perturb disagrees with its twin at M={m}: {err}")
            max_err = max(max_err, err)
    return max_err


def serve_zoo(dev, zoo=ZOO, size: int = 224, native: int = 299, n: int = 64):
    """One served batch of 64 on each victim of ``ZOO`` at 224x224 (K=100,
    eps 8/255 l∞, CW loss): supervised DDrague cut to 5 steps and 5
    unsupervised trials, each timed and traced as in ``serve``; then
    ``fused_perturb`` at Inception's 299x299 and one Inception batch there.
    Returns (fused_perturb launches of the timed runs, the largest error of
    the 299x299 kernel check). (The keyword arguments shrink the run for a
    rehearsal on the CPU.)"""
    from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    launches, max_err = 0, 0.0
    with tempfile.TemporaryDirectory() as root:
        cache = ArtifactCache(root)
        for name, side in [(name, size) for name in zoo] + [("inception_v3", native)]:
            if side == native:
                max_err = check_fused_perturb_inception(dev, native)
            t0 = time.perf_counter()
            victim, images = _served_inputs(dev, name, side, cache, n=n)
            built = time.perf_counter() - t0
            for mode in ("supervised", "unsupervised"):
                attack = ADIL(victim, eps=EPS, n_atoms=100, loss="logits", steps_inference=5,
                              trials=5, cache=cache, attack=mode)
                launches += _serve_mode(attack, images, victim, f"{name} {side}x{side} {mode}",
                                        mode == "unsupervised")
            print(f"zoo {name} at {side}x{side}: {time.perf_counter() - t0:.1f} s in all, "
                  f"{built:.1f} s of it to build the victim and its inputs")
            del victim, images
    return launches, max_err


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


def demo_experiment(dev, root: str, model: str = "densenet", size: int = 224, k: int = 100,
                    n_images: int = 96, per_class=(64, 2, 5), steps: int = 2,
                    batch: int = 64, extra=()):
    """The experiment of ``cli.demo`` through its ``run_experiment`` on its
    default victim, DenseNet-121 (``--model densenet``), at 224x224 with
    seeded random weights: K=100, kappa 50, eps
    8/255 l∞, CW loss, 2 epochs at batch 64, 100 DDrague steps a served
    batch. The data are 96 seeded U(0, 1) images labelled by the victim; the
    rows of its most-predicted label are split [64, 2, 5] as one class.
    ``extra`` adds ``cli.demo`` flags (``--distributed --mixed-precision``).
    Returns the (fused_perturb, fused_adamw_project) launches of the run.
    (The keyword arguments shrink the run for a rehearsal on the CPU.)"""
    import numpy as np

    from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
    from dl_attack_on_imagenet_tpu_torch.cli import demo
    from dl_attack_on_imagenet_tpu_torch.cli._victim import build_victim
    from dl_attack_on_imagenet_tpu_torch.data import ArrayDataset
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project, fused_perturb
    from dl_attack_on_imagenet_tpu_torch.utils import load_artifact

    args = demo.build_argparser().parse_args([
        "--model", model, "--seed", "0", "--n-atoms", str(k), "--kappa", "50",
        "--eps", repr(EPS), "--steps", str(steps), "--batch-size", str(batch),
        "--steps-inference", "100", "--device", str(dev), "--dict-dir", f"{root}/dicts",
        "--results-dir", f"{root}/results", *extra])
    victim = build_victim(args)
    images = np.random.default_rng(0).random((n_images, size, size, 3), dtype=np.float32)
    labels = core.predict_labels(victim, torch.as_tensor(images, device=dev)).cpu().numpy()
    counts = np.bincount(labels)
    top = int(counts.argmax())
    histogram = {int(c): int(n) for c, n in enumerate(counts) if n}
    print(f"demo experiment: {n_images} images, the victim's label histogram {histogram}")
    if counts[top] < sum(per_class):
        raise AssertionError(f"demo experiment: {counts[top]} rows share label {top}, "
                             f"the split {list(per_class)} needs {sum(per_class)}")
    keep = labels == top
    dataset = ArrayDataset(images[keep], labels[keep])
    # The launches the path must make: one fused_perturb a served batch (run_experiment
    # serves val in batches of min(10, n) and test in batches of min(20, n)), two
    # fused_adamw_project a joint gd step (D and v), every epoch.
    n_val, n_test = per_class[1], per_class[2]
    want_perturb = -(-n_val // min(10, n_val)) + -(-n_test // min(20, n_test))
    want_adamw = 2 * steps * -(-per_class[0] // min(batch, per_class[0]))
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    results = demo.run_experiment(victim, dataset, 1, list(per_class), model, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    perturb, adamw = fused_perturb.launches, fused_adamw_project.launches
    path = f"{root}/results/results_{model}_seed0.msgpack"
    saved = load_artifact(path)
    print(f"demo experiment{''.join(' ' + flag for flag in extra)} on {model} at {size}x{size}, K={k}: wall {wall:.2f} s, accuracy "
          f"{results['accuracy']:.4f} on {len(dataset)} rows; fused_perturb launches {perturb} "
          f"(the path makes {want_perturb}), fused_adamw_project launches {adamw} "
          f"(the path makes {want_adamw}); results file {path} ({len(saved)} keys)")
    for split in ("val", "test"):
        key = results[split]["group_key"]["adil"]
        got = {m: results[split][m][key][0] for m in ("fooling_rate", "rmse", "mse", "time")}
        print(f"  {split}: fooling rate {got['fooling_rate']:.4f}, rmse {got['rmse']:.6e}, "
              f"mse {got['mse']:.6f}, wall {got['time']:.3f} s")
        if not (0 <= got["fooling_rate"] <= 1 and np.isfinite([got["rmse"], got["mse"]]).all()
                and got["rmse"] >= 0 and got["mse"] >= 0):
            raise AssertionError(f"demo experiment: bad {split} metrics {got}")
    if perturb != want_perturb or adamw != want_adamw:
        raise AssertionError(f"demo experiment: launches {perturb} / {adamw}, the path makes "
                             f"{want_perturb} / {want_adamw}")
    if results["accuracy"] != 1.0:
        raise AssertionError(f"demo experiment: accuracy {results['accuracy']} on the "
                             "victim's own labels")
    if f"val/fooling_rate/{results['val']['group_key']['adil']}" not in saved:
        raise AssertionError(f"demo experiment: {path} lacks the val fooling rate")
    return perturb, adamw


def single_image_attack(dev, root: str, model: str = "mobilenet", dictionary_of: str = "densenet"):
    """``cli.main.attack_image`` on its default victim, MobileNetV2
    (``--model mobilenet``), with the dictionary that the demo phase learned
    on ``dictionary_of`` saved under this model in the same ``--dict-dir``
    (a transfer: the dictionary's shape does not depend on the victim):
    supervised DDrague with the CE loss on cli.main's seeded synthetic
    image, no training and no figure.

    A seed-0 random victim is so sure of its label that its softmax is 1 in
    fp32, where CE has no gradient and DDrague stops before its first step.
    So the victim comes through ``--weights``: the seed-0 weights with the
    classifier (the last ``nn.Linear``) divided by the gap between the
    image's two top logits (a temperature: every label stays, the top-1
    probability drops below 1). Fails unless the attack moved the image.
    Returns the (fused_perturb, fused_adamw_project) launches."""
    from dl_attack_on_imagenet_tpu_torch.cli import main as cli_main
    from dl_attack_on_imagenet_tpu_torch.cli._victim import build_victim
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project, fused_perturb
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    cache = ArtifactCache(f"{root}/dicts")
    cache.save({"d": cache.load("ImageNet", model=dictionary_of)["d"]}, "ImageNet", model=model)
    argv = ["--model", model, "--device", str(dev), "--dict-dir", f"{root}/dicts"]
    seeded = build_victim(cli_main.build_argparser().parse_args(argv))
    image = torch.as_tensor(cli_main.synthetic_image(seeded.input_size), device=dev)[None]
    with torch.no_grad():
        top = seeded(image).topk(2).values[0]
    gap = max(float(top[0] - top[1]), 1.0)  # a gap under 1 saturates nothing
    weights = {k: v.cpu() for k, v in seeded.net.state_dict().items()}
    head = [name for name, mod in seeded.net.named_modules() if isinstance(mod, torch.nn.Linear)][-1]
    for key in (f"{head}.weight", f"{head}.bias"):
        weights[key] = weights[key] / gap
    torch.save(weights, f"{root}/{model}_tempered.pth")
    del seeded, weights
    args = cli_main.build_argparser().parse_args(
        argv + ["--weights", f"{root}/{model}_tempered.pth"])
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    x, adv, label, attack_label = cli_main.attack_image(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    linf = float((adv - x).abs().max())
    perturb, adamw = fused_perturb.launches, fused_adamw_project.launches
    with torch.no_grad():
        p_max = float(torch.softmax(build_victim(args)(x), -1).max())
    print(f"single-image attack on {model}: wall {wall:.2f} s (victim build and weight load "
          f"included), label {int(label[0])} -> {int(attack_label[0])}, |adv - x|_inf "
          f"{linf:.6f} against eps {args.eps:.6f} (DDrague may exceed it), fused_perturb "
          f"launches {perturb}, fused_adamw_project launches {adamw}; classifier {head} "
          f"divided by the top-2 logit gap {gap:.4f}, clean top-1 probability {p_max:.9f}")
    if adv.shape != x.shape or not bool(torch.isfinite(adv).all()):
        raise AssertionError(f"single-image attack: bad adversary {tuple(adv.shape)}")
    if not (float(adv.min()) >= 0 and float(adv.max()) <= 1):
        raise AssertionError("single-image attack: the adversary leaves [0, 1]")
    if not (torch.equal(x, image) and linf > 0):
        raise AssertionError(f"single-image attack: no attack on the synthetic image "
                             f"(|adv - x|_inf {linf})")
    if perturb != 1 or adamw != 0:
        raise AssertionError(f"single-image attack: launches {perturb} / {adamw}, the path "
                             "makes 1 / 0 (no training)")
    return perturb, adamw


def _set_precision() -> None:
    """True fp32 matmuls and convolutions, bf16 products summed in fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def mixed_precision(dev, model: str = "resnet50", size: int = 224, n: int = 64, k: int = 100,
                    steps_inference: int = 30):
    """bf16 beside fp32 on ResNet-50: 10 chained ``gd`` steps after one
    warm-up from one initial state, then a supervised DDrague batch and a
    supervised AdamW-codes batch through the ADIL entry points. Returns the
    (fused_perturb, fused_adamw_project) launches of the timed runs. (The
    keyword arguments shrink the run for a rehearsal on the CPU.)"""
    import dataclasses

    from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
    from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project, fused_perturb
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    n_steps = 10
    victim = create_model(model, input_size=size, device=dev, seed=0)
    cfg32 = core.AdilConfig(eps=EPS, norm="linf", n_atoms=k, loss="logits", kappa=50.0,
                            step_size=0.01, batch_size=n)
    g = torch.Generator(device=dev).manual_seed(1)
    images = torch.rand((n, size, size, 3), generator=g, device=dev)
    start = core.init_state(g, (size, size, 3), n, cfg32)
    labels = core.predict_labels(victim, images)
    idx, mask = torch.arange(n, device=dev), torch.ones(n, device=dev)
    runs, adamw = {}, 0
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(cfg32, perturb_dtype=dtype)
        state = core.TrainState(**{key: (val.clone() if torch.is_tensor(val) else val)
                                   for key, val in vars(start).items()})
        core.make_train_step(victim, cfg, "both")(state, images, labels, idx, mask)  # warm-up
        scan = core.make_train_scan(victim, cfg, "both", n_steps=n_steps)
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        losses, foolings = scan(state, images, labels, idx, mask)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_adamw_project.launches
        adamw += launches
        runs[dtype] = losses
        print(f"mixed precision, gd step in {dtype} on {model} at b{n} K={k} {size}x{size}: "
              f"{wall / n_steps * 1e3:.2f} ms/step over {n_steps} chained steps, "
              f"fused_adamw_project launches {launches}; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, fooling {int(foolings[-1])}/{n}")
        if launches != 2 * n_steps:
            raise AssertionError(f"{dtype} train: {launches} launches in {n_steps} steps")
        if not all(t.dtype == torch.float32 for t in (state.d, state.v, state.d_mu, state.v_nu)):
            raise AssertionError(f"{dtype} train: the master state left fp32")
        _check_trained(f"{dtype} train", state.d, state.v, EPS)
    rel = float(((runs["bfloat16"] - runs["float32"]).abs() / runs["float32"].abs()).max())
    print(f"  bf16 losses against fp32: max relative difference {rel:.3e} (tol 0.02)")
    if not rel <= 0.02:
        raise AssertionError(f"bf16 training left fp32's losses: {rel}")

    # The solvers: first a run at the JAX package's own bf16-against-fp32
    # configuration (5 steps, tests/test_mixed_precision.py), which is also
    # the warm-up and is held to its 0.05; then the timed run at the served
    # one (30 DDrague steps, 100 AdamW code steps), whose trajectories have
    # had 6 to 20 times the steps to part: its difference is printed.
    perturb = 0
    short = dict(steps_inference=5, steps_code=5)
    with tempfile.TemporaryDirectory() as root:
        cache = ArtifactCache(root)
        victim, images = _served_inputs(dev, model, size, cache, n=n, k=k)
        for mode in ("supervised", "supervised_adamw"):
            adv, adv_short = {}, {}
            for dtype in ("float32", "bfloat16"):
                attack = ADIL(victim, eps=EPS, n_atoms=k, loss="logits",
                              steps_inference=steps_inference, cache=cache, perturb_dtype=dtype)
                run = attack.forward_supervised_adamw if mode == "supervised_adamw" else attack
                full_cfg = attack.cfg
                attack.cfg = dataclasses.replace(full_cfg, **short)
                adv_short[dtype] = run(images)
                attack.cfg = full_cfg
                torch.cuda.synchronize()
                _zero_counts()
                t0 = time.perf_counter()
                adv[dtype] = run(images)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = (fused_perturb.launches, fused_adamw_project.launches)
                perturb += launches[0]
                linf = float((adv[dtype] - images).abs().max())
                print(f"mixed precision, serve {mode} in {dtype}: wall {wall:.3f} s, launches "
                      f"{launches[0]} / {launches[1]}, |adv - x|_inf {linf:.6f}")
                if launches != (1, 0):
                    raise AssertionError(f"{mode} {dtype}: launches {launches}, the path makes 1 / 0")
                a = adv[dtype]
                if a.dtype != torch.float32 or not bool(torch.isfinite(a).all()) or not (
                        float(a.min()) >= 0 and float(a.max()) <= 1):
                    raise AssertionError(f"{mode} {dtype}: bad adversaries")
                if mode == "supervised_adamw" and not linf <= EPS + 1e-5:
                    raise AssertionError(f"{mode} {dtype}: l∞ budget broken: {linf}")
            diff_short = float((adv_short["bfloat16"] - adv_short["float32"]).abs().max())
            gap = (adv["bfloat16"] - adv["float32"]).abs()
            print(f"  {mode}: bf16 against fp32 adversaries at 5 steps max_abs_diff "
                  f"{diff_short:.6f} (tol 0.05); at the served steps max_abs_diff "
                  f"{float(gap.max()):.6f}, mean {float(gap.mean()):.3e}")
            if not diff_short < 0.05:
                raise AssertionError(f"{mode}: bf16 left fp32's adversaries: {diff_short}")
    return perturb, adamw


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms while a DP run is held against its
    serial replay: otherwise two runs of one step differ in the last bits of
    the victim's input gradient, and AdamW's first step turns a near-zero
    gradient's sign into a full lr step of D."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def _replay(dev, victim, images, cfg, mesh, n_dev: int, epochs: int):
    """The serial replay, on ``mesh`` (one rank), of a DP run of ``n_dev``
    ranks from seed 0: its initial state, its plans and its union batches.
    Returns the replayed state."""
    from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
    from dl_attack_on_imagenet_tpu_torch.parallel import adil_dp

    n = images.shape[0]
    n_local = -(-n // n_dev)
    state = adil_dp.init_dp_state(dev, images.shape[1:], n_local * n_dev, cfg, mesh, seed=0)
    rows = adil_dp.shard_rows(mesh, images, device=dev)
    labels = core.predict_labels(victim, rows[:n])
    labels = torch.cat([labels, labels.new_zeros(rows.shape[0] - n)])
    plans, replay = adil_dp.plan_generator(0), adil_dp.make_dp_replay_epoch_fn(victim, cfg)
    for _ in range(epochs):
        plan = adil_dp.make_local_batches(plans, n, n_dev, cfg.batch_size)
        replay(state, rows, labels, adil_dp.global_batches_from_local(plan, n_local))
    return state


def dp_world_one(dev, model: str = "resnet50", size: int = 224, n: int = 128, b: int = 64,
                 k: int = 100) -> int:
    """``ADIL(mesh=data_mesh())`` at world size 1 over NCCL on ResNet-50: 2
    epochs of 128 images at b64 with a checkpoint after each, held against
    its serial replay (1e-5) and with the sharded accuracy equal to the
    unsharded one. Returns the fused_adamw_project launches. (The keyword
    arguments shrink the run for a rehearsal on the CPU.)"""
    import numpy as np
    import torch.distributed as dist

    from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
    from dl_attack_on_imagenet_tpu_torch.evaluation import model_accuracy, model_accuracy_sharded
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project
    from dl_attack_on_imagenet_tpu_torch.parallel import auto_initialize, check_mesh, data_mesh
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    auto_initialize(device=dev)
    backend = dist.get_backend()
    mesh = data_mesh()
    health = check_mesh(mesh)
    print(f"dp world size 1: backend {backend}, mesh {mesh}, check_mesh {health}")
    if not health["ok"] or (dev.type == "cuda" and backend != "nccl"):
        raise AssertionError(f"dp world size 1: mesh not healthy or not NCCL: {health}")
    victim = create_model(model, input_size=size, device=dev, seed=0)
    images = np.random.default_rng(2).random((n, size, size, 3), dtype=np.float32)
    labels = victim.predict(torch.as_tensor(images, device=dev)).cpu().numpy()
    labels[::3] = (labels[::3] + 1) % victim.num_classes  # a third wrong
    t0 = time.perf_counter()
    sharded = model_accuracy_sharded((images, labels), victim, mesh)
    plain = model_accuracy((images, labels), victim)
    print(f"  model_accuracy_sharded {sharded:.6f}, model_accuracy {plain:.6f} "
          f"({time.perf_counter() - t0:.2f} s both)")
    if sharded != plain:
        raise AssertionError("dp world size 1: sharded accuracy differs")
    with tempfile.TemporaryDirectory() as root, _deterministic_cudnn():
        cache = ArtifactCache(root)
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        attack = ADIL(victim, eps=EPS, n_atoms=k, batch_size=b, loss="logits", steps=2,
                      data_train=(images, np.zeros((n,), np.int64)), cache=cache, mesh=mesh,
                      checkpoint_every=1, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_adamw_project.launches
        saved = cache.load("ImageNet", model=victim.name)
        left = cache.exists("ImageNet", model=victim.name, kind="dp_train_state_torch")
    print(f"  ADIL(mesh=data_mesh()) on {model} at {size}x{size}, {n} images, b{b}, 2 epochs: "
          f"wall {wall:.2f} s, epochs {attack.timing}, fused_adamw_project launches {launches}, "
          f"loss {attack.history['loss']}")
    want = 2 * 2 * -(-n // b)
    if launches != want:
        raise AssertionError(f"dp world size 1: {launches} launches, the path makes {want}")
    if saved is None or left:
        raise AssertionError("dp world size 1: no artifact, or the train state was left")
    t0 = time.perf_counter()
    with _deterministic_cudnn():
        state = _replay(dev, victim, images, attack.cfg, mesh, 1, 2)
    err = max(float((attack.dictionary.reshape(k, -1) - state.d).abs().max()),
              float((torch.as_tensor(saved["v"], device=dev) - state.v[:n]).abs().max()))
    print(f"  against the serial replay of the same plan: D and v max_abs_err {err:.3e} "
          f"(tol 1e-5; replay {time.perf_counter() - t0:.2f} s; deterministic cuDNN)")
    spread = float((_replay(dev, victim, images, attack.cfg, mesh, 1, 2).d - state.d).abs().max())
    print(f"  the replay again without deterministic cuDNN: D max_abs_diff {spread:.3e}")
    if not err <= 1e-5:
        raise AssertionError(f"dp world size 1 disagrees with its replay: {err}")
    _check_trained("dp world size 1", state.d, state.v, EPS)
    return launches


class _Killed(Exception):
    pass


def _timed_cache(root: str):
    """An ``ArtifactCache`` at ``root`` that keeps the wall of each sharded
    save and restore and the bytes of the directory that a save leaves."""
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    class TimedCache(ArtifactCache):
        def __init__(self, root):
            super().__init__(root)
            self.saves, self.restores, self.bytes = [], [], 0

        def save_sharded(self, tree, prefix, **hyper):
            sync()
            t0 = time.perf_counter()
            p = super().save_sharded(tree, prefix, **hyper)
            self.saves.append(time.perf_counter() - t0)
            self.bytes = sum(os.path.getsize(os.path.join(top, f))
                             for top, _, files in os.walk(p) for f in files)
            return p

        def load_sharded(self, template, prefix, **hyper):
            sync()
            t0 = time.perf_counter()
            out = super().load_sharded(template, prefix, **hyper)
            sync()
            self.restores.append(time.perf_counter() - t0)
            return out

    return TimedCache(root)


def _kill_and_resume(learn, cache):
    """``learn(cache)`` killed just after its first sharded checkpoint (on
    every rank, so that none waits in a collective), then run again to
    resume from it; returns the resumed run's (D, v, history)."""
    from dl_attack_on_imagenet_tpu_torch.parallel import adil_dp

    real = adil_dp._ckpt_save_sharded

    def save_then_kill(*args):
        real(*args)
        raise _Killed

    adil_dp._ckpt_save_sharded = save_then_kill
    try:
        learn(cache)
        raise AssertionError("sharded checkpoint: the run was not killed")
    except _Killed:
        pass
    finally:
        adil_dp._ckpt_save_sharded = real
    if not cache.saves:
        raise AssertionError("sharded checkpoint: the killed run left no checkpoint")
    return learn(cache)


def _same_run(a, b) -> bool:
    """Two runs' (D, v, history) bit for bit."""
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and a[2]["loss"] == b[2]["loss"] and a[2]["fooling_rate"] == b[2]["fooling_rate"])


# The rows of the full ImageNet train set, the codes' size at K=100.
IMAGENET_TRAIN = 1_281_167


def codes_checkpoint_walls(dev, root: str, n: int = IMAGENET_TRAIN, k: int = 100) -> dict:
    """Both DP checkpoints of v and its two moments alone at ``n`` rows,
    timed on this rank; every rank of the default group calls it. The
    sharded one: ``save_sharded`` of three ``Shard(0)`` DTensors of this
    rank's rows, and ``load_sharded`` back into zeroed rows. The rank-0
    one, as ``learn_dictionary_distributed(ckpt_sharded=False)`` makes it:
    the all-reduce gather of the three onto every rank and rank 0's msgpack
    save, then each rank's load of the file and copy of its rows to the
    card. Both restores are held bit-equal to the rows. Returns the walls
    (s, each ending with every rank done) and the bytes on disk."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from dl_attack_on_imagenet_tpu_torch.parallel import data_mesh
    from dl_attack_on_imagenet_tpu_torch.parallel.adil_dp import _barrier, _gather_rows
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    mesh = data_mesh()
    world, rank, group = mesh.size(), dist.get_rank(), mesh.get_group("data")
    n_local = -(-n // world)
    g = torch.Generator(device=dev).manual_seed(rank)
    rows = {name: torch.rand((n_local, k), generator=g, device=dev)
            for name in ("v", "v_mu", "v_nu")}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def as_dtensors(tensors):
        return {name: DTensor.from_local(t, mesh, [Shard(0)], run_check=False)
                for name, t in tensors.items()}

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        _barrier(dev, group)
        return time.perf_counter() - t0, out

    cache = ArtifactCache(root)
    out = {"rows": n, "world": world}
    out["sharded_save"], p = timed(lambda: cache.save_sharded(as_dtensors(rows), "codes"))
    out["sharded_bytes"] = sum(os.path.getsize(os.path.join(top, f))
                               for top, _, files in os.walk(p) for f in files)
    back = {name: torch.zeros_like(t) for name, t in rows.items()}
    out["sharded_restore"], _ = timed(lambda: cache.load_sharded(as_dtensors(back), "codes"))
    out["sharded_equal"] = all(torch.equal(back[name], rows[name]) for name in rows)
    cache.remove_sharded("codes")
    del back

    def gather_and_write():
        whole = {name: _gather_rows(t, world, rank, group) for name, t in rows.items()}
        return cache.save(whole, "codes") if rank == 0 else None

    out["msgpack_save"], _ = timed(gather_and_write)
    out["msgpack_bytes"] = os.path.getsize(cache.path("codes"))

    def read_own_rows():
        payload = cache.load("codes")
        return {name: torch.as_tensor(payload[name][rank * n_local:(rank + 1) * n_local]).to(dev)
                for name in rows}

    out["msgpack_restore"], back = timed(read_own_rows)
    out["msgpack_equal"] = all(torch.equal(back[name], rows[name]) for name in rows)
    _barrier(dev, group)
    if rank == 0:
        cache.remove("codes")
    return out


def _print_codes_walls(label: str, w) -> None:
    print(f"{label} codes checkpoint, v and its moments at {int(w['rows'])}x100 fp32 over "
          f"{int(w['world'])} rank(s) ({CARD}): sharded save {float(w['sharded_save']):.4f} s, "
          f"restore {float(w['sharded_restore']):.4f} s, {int(w['sharded_bytes'])} bytes, "
          f"bit-equal {bool(w['sharded_equal'])}; rank-0 gather and msgpack save "
          f"{float(w['msgpack_save']):.4f} s, each rank's load {float(w['msgpack_restore']):.4f} "
          f"s, {int(w['msgpack_bytes'])} bytes, bit-equal {bool(w['msgpack_equal'])}")
    if not (w["sharded_equal"] and w["msgpack_equal"]):
        raise AssertionError(f"{label} codes checkpoint: a restore differs from the rows")


def dp_sharded(dev, model: str = "resnet50", size: int = 224, n: int = 128, b: int = 64,
               k: int = 100, epochs: int = 2, codes_kw=None) -> int:
    """``learn_dictionary_distributed(ckpt_sharded=True)`` at world size 1
    over NCCL on ResNet-50 at 224x224, K=100, 128 images at b64, with a
    checkpoint each epoch: whole, and killed just after its first
    checkpoint, then resumed; the resumed D, v and history equal the whole
    run's bit for bit (deterministic cuDNN). Prints the sharded saves' and
    the restore's walls and the directory's bytes (D and its moments, 3 x K
    x H*W*C fp32, and v and its moments); then both checkpoints of the
    full ImageNet train set's codes (:func:`codes_checkpoint_walls`).
    Returns the fused_adamw_project launches. (The keyword arguments shrink
    the run for a rehearsal on the CPU.)"""
    codes_kw = codes_kw or {}
    import numpy as np
    import torch.distributed as dist

    from dl_attack_on_imagenet_tpu_torch.attacks.adil_core import AdilConfig
    from dl_attack_on_imagenet_tpu_torch.data import ArrayDataset
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project
    from dl_attack_on_imagenet_tpu_torch.parallel import (
        auto_initialize, data_mesh, learn_dictionary_distributed)

    auto_initialize(device=dev)
    mesh = data_mesh()
    victim = create_model(model, input_size=size, device=dev, seed=0)
    data = ArrayDataset(np.random.default_rng(2).random((n, size, size, 3), dtype=np.float32),
                        np.zeros(n))
    cfg = AdilConfig(eps=EPS, n_atoms=k, loss="logits", batch_size=b, steps=epochs)

    def learn(cache):
        return learn_dictionary_distributed(victim, data, cfg, mesh, seed=0, checkpoint_every=1,
                                            cache=cache, ckpt_sharded=True)

    runs, launches = {}, {}
    with tempfile.TemporaryDirectory() as root, _deterministic_cudnn():
        caches = {name: _timed_cache(f"{root}/{name}") for name in ("whole", "resumed")}
        for name, run in (("whole", learn), ("resumed", lambda c: _kill_and_resume(learn, c))):
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            runs[name] = run(caches[name])
            torch.cuda.synchronize()
            launches[name] = fused_adamw_project.launches
            print(f"  {name}: wall {time.perf_counter() - t0:.2f} s, fused_adamw_project launches "
                  f"{launches[name]}, loss {runs[name][2]['loss']}")
        left = [c.exists_sharded("ImageNet", model=victim.name, kind="dp_train_state_torch")
                for c in caches.values()]
        print(f"dp sharded checkpoint on {model} at {size}x{size}, K={k}, {n} images at b{b}, "
              f"world size 1 over {dist.get_backend()} ({CARD}): saves "
              f"{[round(w, 4) for w in caches['whole'].saves]} s (whole) and {[round(w, 4) for w in caches['resumed'].saves]} s (killed, "
              f"resumed), restore {[round(w, 4) for w in caches['resumed'].restores]} s, directory "
              f"{caches['whole'].bytes} bytes (D and its moments {3 * k * size * size * 3 * 4} "
              f"bytes)")
        codes = codes_checkpoint_walls(dev, f"{root}/codes", **codes_kw)
    _print_codes_walls("dp sharded checkpoint, world size 1:", codes)
    same = _same_run(runs["whole"], runs["resumed"])
    print(f"  resumed against whole: D, v and history bit-equal {same}")
    want = epochs * 2 * -(-n // b)
    if not same:
        raise AssertionError("dp sharded checkpoint: the resumed run differs from the whole one")
    if any(left) or len(caches["resumed"].restores) != 1:
        raise AssertionError(f"dp sharded checkpoint: left {left}, restores "
                             f"{caches['resumed'].restores}")
    if launches != {"whole": want, "resumed": want}:
        raise AssertionError(f"dp sharded checkpoint: launches {launches}, the path makes {want}")
    _check_trained("dp sharded checkpoint", runs["whole"][0].reshape(k, -1), runs["whole"][1], EPS)
    return launches["whole"] + launches["resumed"]


DP_RANKS = dict(model="tiny", size=32, n=32, b=16, k=100, epochs=2)


def dp_rank_main(rank: int, root: str, device: str, codes_rows: int = IMAGENET_TRAIN) -> None:
    """One rank of :func:`dp_two_ranks`: gloo on ``device`` (both ranks on
    one card), the DP learning of ``DP_RANKS``, then its sharded-checkpoint
    run killed after the first checkpoint and resumed, the results written
    to ``root/rank<rank>.npz``."""
    import numpy as np
    import torch.distributed as dist

    from dl_attack_on_imagenet_tpu_torch.attacks.adil_core import AdilConfig
    from dl_attack_on_imagenet_tpu_torch.data import ArrayDataset
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project
    from dl_attack_on_imagenet_tpu_torch.parallel import (
        auto_initialize, check_mesh, data_mesh, learn_dictionary_distributed)

    _set_precision()
    torch.backends.cudnn.deterministic = True  # as the replay (_deterministic_cudnn)
    c = DP_RANKS
    auto_initialize(device=device, backend="gloo")
    mesh = data_mesh()
    health = check_mesh(mesh)
    victim = create_model(c["model"], input_size=c["size"], device=device, seed=0)
    images = np.random.default_rng(5).random((c["n"], c["size"], c["size"], 3), dtype=np.float32)
    cfg = AdilConfig(eps=EPS, n_atoms=c["k"], loss="logits", batch_size=c["b"], steps=c["epochs"])
    data = ArrayDataset(images, np.zeros(c["n"]))
    _zero_counts()
    t0 = time.perf_counter()
    d, v, history = learn_dictionary_distributed(victim, data, cfg, mesh, seed=0)
    if d.is_cuda:
        torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, fused_adamw_project.launches

    def learn(cache):
        return learn_dictionary_distributed(victim, data, cfg, mesh, seed=0, checkpoint_every=1,
                                            cache=cache, ckpt_sharded=True)

    cache = _timed_cache(f"{root}/sharded")
    _zero_counts()
    resumed = _kill_and_resume(learn, cache)
    np.savez(f"{root}/rank{rank}.npz", d=d.cpu().numpy(), v=v.cpu().numpy(),
             loss=np.asarray(history["loss"]), wall=wall, launches=launches, ok=health["ok"],
             backend=dist.get_backend(), device=str(d.device),
             sharded_same=_same_run((d, v, history), resumed),
             sharded_launches=fused_adamw_project.launches, sharded_saves=cache.saves,
             sharded_restores=cache.restores, sharded_bytes=cache.bytes,
             sharded_left=cache.exists_sharded("ImageNet", model=victim.name,
                                               kind="dp_train_state_torch"),
             **{f"codes_{key}": value for key, value in codes_checkpoint_walls(
                 torch.device(device), f"{root}/codes", n=codes_rows).items()})
    dist.destroy_process_group()


def dp_two_ranks(dev, timeout: int = 300, codes_rows: int = IMAGENET_TRAIN) -> int:
    """Two ranks on the one card over gloo, spawned as ``chip_smoke.py
    --dp-rank R DIR DEVICE``, both on ``dev``: both ranks' D and v
    identical, and within 1e-5 of the serial replay on ``dev``; each rank's
    sharded-checkpoint run, killed and resumed, equal to its whole run bit
    for bit; then both checkpoints of ``codes_rows`` rows of codes over the
    two ranks (:func:`codes_checkpoint_walls`). Returns both ranks'
    fused_adamw_project launches, both runs."""
    import numpy as np

    from dl_attack_on_imagenet_tpu_torch.attacks.adil_core import AdilConfig
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.parallel import auto_initialize, data_mesh

    c = DP_RANKS
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as root:
        env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
               "WORLD_SIZE": "2", "LOCAL_RANK": "0"}
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank",
                                   str(r), root, str(dev), str(codes_rows)],
                                  env={**env, "RANK": str(r)})
                 for r in range(2)]
        try:
            codes = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                p.kill()
        wall = time.perf_counter() - t0
        if codes != [0, 0]:
            raise AssertionError(f"dp 2 ranks: the ranks exited with {codes}")
        ranks = [dict(np.load(f"{root}/rank{r}.npz")) for r in range(2)]
    for r, out in enumerate(ranks):
        print(f"dp 2 ranks, rank {r}: backend {out['backend']}, {out['device']}, check_mesh ok "
              f"{bool(out['ok'])}, learn {float(out['wall']):.2f} s, fused_adamw_project "
              f"launches {int(out['launches'])}, loss {out['loss'].tolist()}")
        print(f"  rank {r} sharded checkpoint ({CARD}): killed and resumed equal to the "
              f"whole run {bool(out['sharded_same'])}, fused_adamw_project launches "
              f"{int(out['sharded_launches'])}, saves {out['sharded_saves'].round(4).tolist()} s, "
              f"restore {out['sharded_restores'].round(4).tolist()} s, directory "
              f"{int(out['sharded_bytes'])} bytes")
        _print_codes_walls(f"dp 2 ranks, rank {r}:", {key[6:]: value for key, value in
                                                      out.items() if key.startswith("codes_")})
    print(f"  both ranks, spawn to exit: {wall:.1f} s")
    same = all(np.array_equal(ranks[0][key], ranks[1][key]) for key in ("d", "v", "loss"))
    want = 2 * c["epochs"] * -(-(c["n"] // 2) // (c["b"] // 2))
    if not (same and all(bool(out["ok"]) for out in ranks)):
        raise AssertionError("dp 2 ranks: the ranks disagree or the mesh is not healthy")
    if not all(bool(out["sharded_same"]) and not bool(out["sharded_left"])
               and out["sharded_restores"].size == 1 for out in ranks):
        raise AssertionError("dp 2 ranks: the sharded kill-and-resume differs from the whole run "
                             "or left its checkpoint")
    if [int(out["sharded_launches"]) for out in ranks] != [want, want]:
        raise AssertionError(f"dp 2 ranks: sharded launches, the path makes {want} a rank")
    victim = create_model(c["model"], input_size=c["size"], device=dev, seed=0)
    images = np.random.default_rng(5).random((c["n"], c["size"], c["size"], 3), dtype=np.float32)
    cfg = AdilConfig(eps=EPS, n_atoms=c["k"], loss="logits", batch_size=c["b"], steps=c["epochs"])
    auto_initialize(device=dev)  # the replay's mesh: this process alone
    with _deterministic_cudnn():
        state = _replay(dev, victim, images, cfg, data_mesh(), 2, c["epochs"])
    err = max(float((torch.as_tensor(ranks[0]["d"], device=dev).reshape(c["k"], -1)
                     - state.d).abs().max()),
              float((torch.as_tensor(ranks[0]["v"], device=dev) - state.v[:c["n"]]).abs().max()))
    print(f"  against the serial replay on the card: D and v max_abs_err {err:.3e} (tol 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"dp 2 ranks disagree with the replay: {err}")
    if [int(out["launches"]) for out in ranks] != [want, want]:
        raise AssertionError(f"dp 2 ranks: launches, the path makes {want} a rank")
    return 4 * want


def check_baselines_against_cpu(dev) -> None:
    """DeepFool and one UAP-PGD epoch on the card against the CPU on the
    tiny victim at 32x32: DeepFool's iteration counts exact and its
    perturbations within 1e-4 (each step divides by a gradient norm, and
    cuDNN sums in another order), UAP-PGD's l2 ``e`` within 1e-5."""
    from dl_attack_on_imagenet_tpu_torch.attacks import UAPPGD, adil_core, deepfool_batch, uap_pgd
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(3)
    victim_cpu = create_model("tiny", device=cpu, seed=1)
    victim_dev = create_model("tiny", device=dev, state_dict=victim_cpu.net.state_dict())
    images = torch.rand((10, 32, 32, 3), generator=g)
    r_cpu, it_cpu = deepfool_batch(victim_cpu, images[:8], 10, 0.02, 10)
    r_dev, it_dev = deepfool_batch(victim_dev, images[:8].to(dev), 10, 0.02, 10)
    err_df = float((r_dev.cpu() - r_cpu).abs().max())
    labels = victim_cpu.predict(images)
    plan = adil_core.make_batches(g, 10, 4)
    es = []
    with tempfile.TemporaryDirectory() as root:
        for victim, where in ((victim_cpu, cpu), (victim_dev, dev)):
            attack = UAPPGD(victim, steps=0, batch_size=4, norm="l2", eps=0.1,
                            cache=ArtifactCache(root))
            e = torch.zeros((1, 32, 32, 3), device=where, requires_grad=True)
            uap_pgd.make_uap_epoch_fn(victim, attack)(e, attack.make_optimizer([e]),
                                                      images.to(where), labels.to(where),
                                                      plan.to(where))
            es.append(e.detach().cpu())
    err_uap = float((es[0] - es[1]).abs().max())
    print(f"small-size deepfool: card vs CPU iters {it_dev.tolist()} / {it_cpu.tolist()}, "
          f"r_tot max_abs_err {err_df:.3e} (tol 1e-4); uap-pgd l2 epoch: e max_abs_err "
          f"{err_uap:.3e} (tol 1e-5)")
    if not (torch.equal(it_dev.cpu(), it_cpu) and err_df <= 1e-4 and err_uap <= 1e-5):
        raise AssertionError("the baselines on the card disagree with the CPU")


def _timed_run(fn):
    """(result, wall s) of one call of ``fn`` that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _fooled_share(victim, adv, images) -> float:
    return float((victim.predict(adv) != victim.predict(images)).float().mean())


@torch.no_grad()
def _top1_probability(victim, images, b: int = 64) -> torch.Tensor:
    return torch.cat([torch.softmax(victim(images[i:i + b]), -1).max(-1).values
                      for i in range(0, images.shape[0], b)])


@torch.no_grad()
def _temper(victim, images, b: int = 64):
    """Divide the classifier by the median top-2 logit gap of ``images``: a
    temperature, under which every label stays. Returns the gap and the
    clean top-1 probabilities after it."""
    top2 = torch.cat([victim(images[i:i + b]).topk(2).values
                      for i in range(0, images.shape[0], b)])
    gap = max(float((top2[:, 0] - top2[:, 1]).median()), 1.0)
    head = [mod for mod in victim.net.modules() if isinstance(mod, torch.nn.Linear)][-1]
    head.weight.div_(gap)
    head.bias.div_(gap)
    return gap, _top1_probability(victim, images, b)


def universal_baselines(dev, model: str = "resnet50", size: int = 224, n_train: int = 256,
                        b: int = 64, n_df: int = 16, n_uni: int = 16, n_val: int = 16,
                        transfer: str = "densenet121") -> None:
    """The universal baselines on ResNet-50 at 224x224 through their entry
    points, at the JAX package's operating points
    (``benchmarks/attack_family_bench.py``): UAP-PGD (l2, eps 0.1, Adam,
    b64) learning 3 epochs on 256 images after a 1-epoch warm-up, one
    traced epoch, served on a batch of 64, and learned data-parallel at
    world size 1 over NCCL against its serial replay; DeepFool and
    DeepFoolCosinus on a batch of 16 (10 classes, 10 iterations), timed
    after a warm-up and traced; Fast-UAP and the universal perturbation
    on 16 images with 16 for val (chunk 1, DeepFool at most 10
    iterations); the harness's lazy ``learn_attack`` on a batch the victim
    partly misclassifies, and the transfer of the learned UAP onto
    ResNet-50 and DenseNet-121; then the small-size card-against-CPU
    checks. The path launches neither kernel, which it checks. (The
    keyword arguments shrink the run for a rehearsal on the CPU.)"""
    import numpy as np

    import torch.distributed as dist

    from dl_attack_on_imagenet_tpu_torch.attacks import (
        UAPPGD, FastUAP, deepfool_batch, fast_uap, uap_pgd, universal_perturbation)
    from dl_attack_on_imagenet_tpu_torch.attacks.adil_core import make_batches
    from dl_attack_on_imagenet_tpu_torch.evaluation import get_performance, get_transfer_performance
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project, fused_perturb
    from dl_attack_on_imagenet_tpu_torch.parallel import adil_dp, auto_initialize, data_mesh
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    _zero_counts()
    victim = create_model(model, input_size=size, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(7)
    images = torch.rand((n_train, size, size, 3), generator=g, device=dev)
    # The seed-0 softmax is 1 in fp32, where CE has no gradient and UAP-PGD's
    # loss is exactly 0 (DeepFool and the gates compare logits, which the
    # temperature leaves in order).
    gap, probs = _temper(victim, images)
    labels = victim.predict(images)
    print(f"universal baselines on {model}: classifier divided by the median top-2 logit gap "
          f"{gap:.4f}; clean top-1 probability median {float(probs.median()):.6f}, "
          f"{labels.unique().numel()} distinct labels in {n_train} images")
    data = (images.cpu().numpy(), labels.cpu().numpy())
    uap_kw = dict(batch_size=b, eps=0.1, norm="l2", optimizer="adam")
    tag = f"{model} {size}x{size}"
    with tempfile.TemporaryDirectory() as root:
        # UAP-PGD learning and serving.
        UAPPGD(victim, data_train=data, steps=1, cache=ArtifactCache(f"{root}/warm"), **uap_kw)
        attack, wall = _timed_run(lambda: UAPPGD(victim, data_train=data, steps=3,
                                                 cache=ArtifactCache(f"{root}/uap"), **uap_kw))
        e = attack.attack_vec
        norm = float(e.norm())
        print(f"uap-pgd learn on {tag}, {n_train} images, b{b}, l2 eps 0.1, adam: UAPPGD(steps=3) "
              f"wall {wall:.3f} s (after a 1-epoch warm-up; the upload of the images, 3 epochs "
              f"and the artifact's write), loss {attack.history['loss']}, |e|_2 {norm:.6f}")
        if e.shape != (1, size, size, 3) or not bool(torch.isfinite(e).all()) or not (
                norm <= 0.1 + 1e-5):
            raise AssertionError(f"uap-pgd: bad perturbation, |e|_2 {norm}")
        # The bare epoch on the resident tensors: a warm-up, then the mean of 3.
        epoch_fn = uap_pgd.make_uap_epoch_fn(victim, attack)
        e_run = e.clone().requires_grad_(True)
        opt = attack.make_optimizer([e_run])
        plan = make_batches(torch.Generator().manual_seed(1), n_train, b).to(dev)
        epoch_fn(e_run, opt, images, labels, plan)
        walls = [_timed_run(lambda: epoch_fn(e_run, opt, images, labels, plan))[1]
                 for _ in range(3)]
        wall = sum(walls) / 3
        print(f"uap-pgd epoch on {tag}, {n_train} resident images, b{b}: {wall * 1e3:.3f} ms/epoch "
              f"(mean of 3 after a warm-up; {', '.join(f'{w * 1e3:.3f}' for w in walls)} ms)")
        print_device_breakdown("uap-pgd epoch", lambda: epoch_fn(e_run, opt, images, labels, plan),
                               wall)
        served, served_labels = images[:b], labels[:b]
        attack(served, served_labels)  # warm-up
        adv, wall = _timed_run(lambda: attack(served, served_labels))
        print(f"uap-pgd serve b{b}: wall {wall * 1e3:.2f} ms, fooled share "
              f"{_fooled_share(victim, adv, served):.4f}, |adv - x|_2 max "
              f"{float((adv - served).flatten(1).norm(dim=1).max()):.6f}")
        if adv.shape != served.shape or not (float(adv.min()) >= 0 and float(adv.max()) <= 1):
            raise AssertionError("uap-pgd serving: adversaries leave [0, 1]")

        # Data parallel at world size 1 (NCCL on the card) against its replay.
        auto_initialize(device=dev)
        mesh = data_mesh()
        with _deterministic_cudnn():
            dp, wall = _timed_run(lambda: UAPPGD(victim, data_train=data, steps=2, mesh=mesh,
                                                 cache=ArtifactCache(f"{root}/dp"), **uap_kw))

            def replay():
                e_rep = torch.zeros_like(e).requires_grad_(True)
                opt_rep, plans = attack.make_optimizer([e_rep]), adil_dp.plan_generator(0)
                for _ in range(2):
                    local = adil_dp.make_local_batches(plans, n_train, 1, b)
                    epoch_fn(e_rep, opt_rep, images, labels, torch.as_tensor(
                        adil_dp.global_batches_from_local(local, n_train), device=dev))
                return e_rep.detach()

            replayed, replay_wall = _timed_run(replay)
            err = float((dp.attack_vec - replayed).abs().max())
        spread = float((replay() - replay()).abs().max())
        _, free_wall = _timed_run(replay)
        print(f"uap-pgd dp world size 1 ({dist.get_backend()}): 2 epochs {wall:.3f} "
              f"s, e against the serial replay max_abs_err {err:.3e} (tol 1e-5, deterministic "
              f"cuDNN; the replay {replay_wall:.3f} s there, {free_wall:.3f} s without it); "
              f"two replays without it differ by {spread:.3e}")
        if not err <= 1e-5:
            raise AssertionError(f"uap-pgd dp disagrees with its replay: {err}")

        # DeepFool and DeepFoolCosinus on a batch.
        x = images[:n_df]
        deepfool_batch(victim, x, 10, 0.02, 10)  # warm-up
        (r, iters), wall = _timed_run(lambda: deepfool_batch(victim, x, 10, 0.02, 10))
        adv = torch.clamp(x + r, 0.0, 1.0)
        print(f"deepfool b{n_df} on {tag}, 10 classes, max_iter 10: wall {wall:.3f} s, iters "
              f"{iters.tolist()}, fooled share {_fooled_share(victim, adv, x):.4f} (clipped "
              f"adversaries), |r|_2 median {float(r.flatten(1).norm(dim=1).median()):.4e}")
        if not (bool(torch.isfinite(r).all()) and int(iters.max()) <= 10):
            raise AssertionError("deepfool: non-finite perturbation or too many iterations")
        print_device_breakdown(f"deepfool b{n_df}", lambda: deepfool_batch(victim, x, 10, 0.02, 10),
                               wall)
        fast_uap.deepfool_cosinus_batch(victim, x, e, max_iter=10)  # warm-up
        adv, wall = _timed_run(lambda: fast_uap.deepfool_cosinus_batch(victim, x, e, max_iter=10))
        print(f"deepfool-cosinus b{n_df}, attack_init the uap-pgd e: wall {wall:.3f} s, fooled "
              f"share {_fooled_share(victim, adv, x):.4f}")
        if not (bool(torch.isfinite(adv).all()) and float(adv.min()) >= 0
                and float(adv.max()) <= 1):
            raise AssertionError("deepfool-cosinus: adversaries leave [0, 1]")

        # Fast-UAP and the universal perturbation, counting the DeepFool
        # solves (chunks through the gate) and the increments folded in.
        counts = {"solves": 0, "accepted": 0}
        real_deepfool, real_fold = fast_uap.deepfool_batch, fast_uap.fold_increments

        def counted_deepfool(*args, **kwargs):
            counts["solves"] += 1
            return real_deepfool(*args, **kwargs)

        def counted_fold(v, deltas, accept, *args):
            counts["accepted"] += int(accept.sum())
            return real_fold(v, deltas, accept, *args)

        train = (data[0][:n_uni], data[1][:n_uni])
        val = (data[0][n_uni:n_uni + n_val], data[1][n_uni:n_uni + n_val])
        fast_kw = dict(steps=1, steps_deepfool=10, chunk=1)
        FastUAP(victim, data_train=(train[0][:2], train[1][:2]),
                cache=ArtifactCache(f"{root}/fast_warm"), **fast_kw)  # warm-up at b1
        fast_uap.deepfool_batch, fast_uap.fold_increments = counted_deepfool, counted_fold
        try:
            fast, wall = _timed_run(lambda: FastUAP(victim, data_train=train, data_val=val,
                                                    cache=ArtifactCache(f"{root}/fast"),
                                                    **fast_kw))
            print(f"fast-uap on {tag}, {n_uni} images + {n_val} val, 1 epoch, chunk 1, "
                  f"deepfool <= 10: wall {wall:.3f} s, deepfool solves {counts['solves']}, "
                  f"increments accepted {counts['accepted']}, val fooling "
                  f"{fast.history['fooling_rate']}, |e|_inf {float(fast.attack_vec.abs().max()):.4e}")
            if not bool(torch.isfinite(fast.attack_vec).all()) or fast.attack_vec.shape != e.shape:
                raise AssertionError("fast-uap: bad perturbation")
            # The first image passes the gate against the zero perturbation,
            # so a run that counted no solve was not counted at all.
            if counts["solves"] == 0:
                raise AssertionError("fast-uap: no deepfool solve counted")
            counts.update(solves=0, accepted=0)
            xi = 10 / 255
            (v, history), wall = _timed_run(lambda: universal_perturbation(
                train, val, victim, max_iter_uni=1, max_iter_df=10, xi=xi, p="linf", chunk=1))
            print(f"universal perturbation on {tag}, {n_uni} images + {n_val} val, 1 pass, "
                  f"chunk 1, xi 10/255 linf: wall {wall:.3f} s, deepfool solves "
                  f"{counts['solves']}, increments accepted {counts['accepted']}, val fooling "
                  f"{history}, |v|_inf {float(v.abs().max()):.6f}")
            if v.shape != (size, size, 3) or not float(v.abs().max()) <= xi + 1e-6:
                raise AssertionError("universal perturbation: bad perturbation")
            if counts["solves"] == 0:
                raise AssertionError("universal perturbation: no deepfool solve counted")
        finally:
            fast_uap.deepfool_batch, fast_uap.fold_increments = real_deepfool, real_fold

        # The harness: lazy learn_attack on the kept rows, then the transfer.
        y = labels[:n_df].clone()
        y[::5] = (y[::5] + 1) % victim.num_classes  # the victim misclassifies these
        lazy = {"uappgd": [UAPPGD(victim, steps=3, cache=ArtifactCache(f"{root}/lazy"), **uap_kw)],
                "fastuap": [FastUAP(victim, cache=ArtifactCache(f"{root}/lazy"), **fast_kw)]}
        perf, wall = _timed_run(lambda: get_performance(lazy, victim, [(x, y)]))
        print(f"harness get_performance (lazy learn_attack on {int((y == labels[:n_df]).sum())} "
              f"kept rows of {n_df}): {wall:.3f} s; fooling {perf['fooling_rate']}, rmse "
              f"{perf['rmse']}, time {perf['time']}")
        if not all(group[0].is_trained for group in lazy.values()) or not all(
                np.isfinite(vals).all() for vals in perf["rmse"].values()):
            raise AssertionError("harness: an attack did not learn, or a metric is not finite")
        victims = {model: victim,
                   transfer: create_model(transfer, input_size=size, device=dev, seed=0)}
        moved, wall = _timed_run(lambda: get_transfer_performance(
            {"uappgd": [attack]}, victims, [(x, labels[:n_df])]))
        print(f"harness get_transfer_performance of the uap-pgd e onto {list(victims)}: "
              f"{wall:.3f} s; {moved['uappgd']}")
        if not all(np.isfinite(list(m.values())).all() for m in moved["uappgd"].values()):
            raise AssertionError("transfer: a metric is not finite")
    check_baselines_against_cpu(dev)
    launches = (fused_perturb.launches, fused_adamw_project.launches)
    print(f"universal baselines: fused_perturb / fused_adamw_project launches {launches[0]} / "
          f"{launches[1]} (the path runs neither kernel)")
    if launches != (0, 0):
        raise AssertionError(f"universal baselines launched a kernel: {launches}")


ADILR_K = 10  # ADILR's own default atoms
ADILR_BUDGET = 10 / 255
# ADILR's kernels run cold on its path (after a ResNet-50 pass), and their
# small shapes launch faster than the wrappers enqueue: each cold launch is
# timed after a 1 GiB write, long enough to hide the host's enqueue.
COLD_FLUSH = 1 << 30


def check_kernels_at_adilr_shapes(dev, n: int = 64, m: int = 224 * 224 * 3):
    """Both kernels at ADILR's shapes against their twins, each timed by
    CUDA events beside its bound: ``fused_perturb`` at (64, 10, 150528)
    with eps = budget and eps = inf (1e-5); ``fused_adamw_project`` without
    a clamp on D (10 x 150528) and on v (64 x 10) (1e-6), and on D beside
    ``torch.optim.AdamW(fused=True).step()``, which computes the same
    function there. Each time is cold (L2 flushed, as on the path), warm
    with the host ahead of the card, and back to back. Returns the two
    rows' ADILR entries."""
    from dl_attack_on_imagenet_tpu_torch.ops import (
        fused_adamw_project, fused_adamw_project_reference, fused_perturb,
        fused_perturb_reference)

    k = ADILR_K
    g = torch.Generator(device=dev).manual_seed(9)
    v = torch.randn((n, k), generator=g, device=dev) * 0.1
    d = torch.rand((k, 224, 224, 3), generator=g, device=dev) * 2 - 1
    x = torch.rand((n, 224, 224, 3), generator=g, device=dev)
    bound_ms, bound_by = fused_perturb_bound_ms(n, k, m)
    perturb = {"shape": f"N={n} K={k} M={m}", "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "max_abs_err": 0.0}
    for name, eps in (("budget", ADILR_BUDGET), ("inf", float("inf"))):
        got = fused_perturb(v, d, x, eps)
        want = fused_perturb_reference(v, d.reshape(k, m), x.reshape(n, m), eps).reshape(x.shape)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        launch = lambda: fused_perturb(v, d, x, eps)
        ms = _time_cold_ms(launch, flush_bytes=COLD_FLUSH)
        warm_ms, host_ms = _time_device_ms(launch)
        b2b_ms = _time_ms(launch)
        plain_ms = _time_cold_ms(lambda: fused_perturb_reference(
            v, d.reshape(k, m), x.reshape(n, m), eps), flush_bytes=COLD_FLUSH)
        print(f"fused_perturb at ADILR's N={n} K={k} M={m}, eps={name}: max_abs_err {err:.3e} "
              f"(tol 1e-5), kernel {ms:.4f} ms cold ({warm_ms:.4f} warm with the host ahead, "
              f"{b2b_ms:.4f} back to back; the wrapper enqueues one in {host_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms cold, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{bound_ms / ms:.1%} of it cold)")
        if not err <= 1e-5:
            raise AssertionError(f"fused_perturb disagrees with its twin at K={k}: {err}")
        if eps < 1 and not float((got - x).abs().max()) <= eps + 1e-6:
            raise AssertionError("fused_perturb breaks ADILR's budget")
        perturb["max_abs_err"] = max(perturb["max_abs_err"], err)
        perturb.update({f"ms_eps_{name}": ms, f"warm_ms_eps_{name}": warm_ms,
                        f"back_to_back_ms_eps_{name}": b2b_ms, f"host_ms_eps_{name}": host_ms,
                        f"plain_ms_eps_{name}": plain_ms})
    perturb.update(ms=perturb["ms_eps_budget"], plain_ms=perturb["plain_ms_eps_budget"])

    size = k * m
    adamw = {"shape": f"D {size} and v {n}x{k}, clip inf", "max_abs_err": 0.0}
    for shape in ((k, 224, 224, 3), (n, k)):
        for step in (1, 2):
            p = torch.rand(shape, generator=g, device=dev) * 2 - 1
            grad, mu = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
            nu = torch.rand(shape, generator=g, device=dev) * 0.01
            want = fused_adamw_project_reference(p, grad, mu, nu, step, 0.01,
                                                 clip_val=float("inf"))
            fused_adamw_project(p, grad, mu, nu, step, 0.01, float("inf"))
            torch.cuda.synchronize()
            errs = [float((p - want[0]).abs().max()), float((mu - want[1]).abs().max()),
                    float(((nu - want[2]).abs() / want[2].abs().clamp(min=1e-30)).max())]
            print(f"fused_adamw_project at ADILR's {'x'.join(map(str, shape))} step={step} "
                  f"clip=inf: max_abs_err p {errs[0]:.3e} mu {errs[1]:.3e}, nu max_rel_err "
                  f"{errs[2]:.3e} (tol 1e-6)")
            if not max(errs) <= 1e-6:
                raise AssertionError(f"fused_adamw_project disagrees with its twin: {errs}")
            adamw["max_abs_err"] = max(adamw["max_abs_err"], errs[0], errs[1])
    p = torch.rand((size,), generator=g, device=dev) * 2 - 1
    grad, mu = (torch.randn((size,), generator=g, device=dev) for _ in range(2))
    nu = torch.rand((size,), generator=g, device=dev) * 0.01
    step = lambda: fused_adamw_project(p, grad, mu, nu, 2, 0.01, float("inf"))
    ms = _time_cold_ms(step, flush_bytes=COLD_FLUSH)
    warm_ms, host_ms = _time_device_ms(step)
    b2b_ms = _time_ms(step)
    plain_ms = _time_cold_ms(lambda: fused_adamw_project_reference(
        p, grad, mu, nu, 2, 0.01, clip_val=float("inf")), flush_bytes=COLD_FLUSH)
    lib_p = p.clone().requires_grad_(True)
    lib_p.grad = grad
    opt = torch.optim.AdamW([lib_p], lr=0.01, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-2, fused=True)
    library_ms = _time_cold_ms(opt.step, flush_bytes=COLD_FLUSH)
    library_warm_ms, library_host_ms = _time_device_ms(opt.step)
    library_b2b_ms = _time_ms(opt.step)
    codes = [torch.rand((n, k), generator=g, device=dev) for _ in range(4)]
    v_ms, v_host_ms = _time_device_ms(lambda: fused_adamw_project(*codes, 2, 0.01, float("inf")))
    bound_ms, bound_by = fused_adamw_project_bound_ms(size)
    print(f"fused_adamw_project at ADILR's D ({size}), clip=inf: kernel {ms:.4f} ms cold "
          f"({warm_ms:.4f} warm with the host ahead: the 42 MB fit the 50 MB L2; {b2b_ms:.4f} "
          f"back to back; the wrapper enqueues one in {host_ms:.4f} ms), plain {plain_ms:.4f} "
          f"ms cold, bound {bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of it cold), "
          f"library {library_ms:.4f} ms cold ({library_warm_ms:.4f} warm, {library_b2b_ms:.4f} "
          f"back to back, enqueued in {library_host_ms:.4f}; torch.optim.AdamW(fused=True)"
          f".step(), the same function without a clamp); on v ({n}x{k}) {v_ms:.4f} ms a "
          f"launch warm (enqueued in {v_host_ms:.4f})")
    adamw.update(ms=ms, warm_ms=warm_ms, back_to_back_ms=b2b_ms, host_ms=host_ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                 library_warm_ms=library_warm_ms, library_back_to_back_ms=library_b2b_ms,
                 v_ms=v_ms, v_host_ms=v_host_ms)
    return perturb, adamw


def check_adilr_against_cpu(dev) -> None:
    """ADILR on the card against the CPU on the tiny victim at 32x32, K=4:
    the supervised adversaries (the codes solver, then fused_perturb at the
    budget) within 1e-4 with equal iteration and halving counts, the
    unsupervised ones from the same draws within 1e-4, and two batches of
    the AdamW trainer (D and v) within 1e-4."""
    import numpy as np

    from dl_attack_on_imagenet_tpu_torch.attacks import ADILR, RegularizedConfig
    from dl_attack_on_imagenet_tpu_torch.attacks import adil_regularized
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    cpu = torch.device("cpu")
    victim_cpu = create_model("tiny", device=cpu, seed=3)
    victim_dev = create_model("tiny", device=dev, state_dict=victim_cpu.net.state_dict())
    rng = np.random.default_rng(2)
    train = rng.random((12, 32, 32, 3), dtype=np.float32)
    labels = victim_cpu.predict(torch.as_tensor(train)).numpy()
    x = torch.rand((8, 32, 32, 3), generator=torch.Generator().manual_seed(6))
    y = victim_cpu.predict(x)
    draws = torch.randn((6, 8, 4), generator=torch.Generator().manual_seed(7)) * 0.5
    errs = {}
    with tempfile.TemporaryDirectory() as root:
        cache = ArtifactCache(root)
        cache.save({"d": rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32),
                    "v": rng.laplace(0.3, 0.5, (12, 4)).astype(np.float32),
                    "loss": np.zeros(2, np.float32), "labels": labels.astype(np.int32)},
                   "ADILR", model="tiny", lam1=1e-3, lam2=0.1, atoms=4, steps=100,
                   tag="param_selecting")
        pair = [ADILR(victim, n_atoms=4, trials=6, lambda_l1=1e-3, cache=cache,
                      data_train=(train, labels), attack="unsupervised")
                for victim in (victim_cpu, victim_dev)]
        advs = [atk.forward_unsupervised_conditioned_atoms(x.to(where), None,
                                                           draws=draws.to(where)).cpu()
                for atk, where in zip(pair, (cpu, dev))]
        errs["unsupervised"] = float((advs[0] - advs[1]).abs().max())
        advs, stats = [], []
        for atk, where in zip(pair, (cpu, dev)):
            atk.attack_mode = "supervised"
            advs.append(atk(x.to(where), y.to(where)).cpu())
            stats.append(atk.stats)
        errs["supervised"] = float((advs[0] - advs[1]).abs().max())
    d0 = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    v0 = (rng.random((8, 4)) * 0.1).astype(np.float32)
    cfg = RegularizedConfig(n_atoms=4, batch_size=4, targeted=False, lambda_l2=0.5)
    runs = [adil_regularized.adilr_adamw(victim, x.to(where), cfg, nepochs=1, shuffle=False,
                                         d_init=d0, v_init=v0)
            for victim, where in ((victim_cpu, cpu), (victim_dev, dev))]
    errs["adamw D"] = float((runs[0][0] - runs[1][0].cpu()).abs().max())
    errs["adamw v"] = float((runs[0][1] - runs[1][1].cpu()).abs().max())
    print(f"small-size adilr card vs CPU: max_abs_err {errs} (tol 1e-4); supervised solver "
          f"stats card {stats[1]} / CPU {stats[0]}")
    if stats[0] != stats[1] or not max(errs.values()) <= 1e-4:
        raise AssertionError("ADILR on the card disagrees with the CPU")


def adilr(dev, model: str = "resnet50", size: int = 224, n_det: int = 64, det_steps: int = 10,
          n_adamw: int = 128, b_adamw: int = 64, adamw_epochs: int = 2, n_val: int = 16,
          n_sadil: int = 64, b_sadil: int = 16, n_serve: int = 64):
    """ADILR on ResNet-50 at 224x224 at its own defaults (K=10 atoms,
    lambda_l1 = lambda_l2 = 0.1, budget 10/255, targeted CE, 100 trials,
    codes step 100), seeded random weights: learning through the class
    constructor in each version (``deterministic`` on 64 images with
    ``steps`` cut from 100 to 10; ``adamw`` on 128 images at b64 for 2
    epochs with 16 val images; ``sadil_updated`` on 64 images at b16 for 1
    epoch), then serving a batch of 64 with the ``adamw`` dictionary,
    supervised and in each of the four unsupervised modes, each timed after
    a warm-up, one of each traced; then
    both kernels at ADILR's shapes and the card against the CPU. Returns
    (fused_perturb launches, fused_adamw_project launches, the kernels'
    ADILR entries). (The keyword arguments shrink the run for a rehearsal
    on the CPU.)"""
    import numpy as np

    from dl_attack_on_imagenet_tpu_torch.attacks import ADILR, AdilConfig
    from dl_attack_on_imagenet_tpu_torch.attacks.adil import val_fooled
    from dl_attack_on_imagenet_tpu_torch.attacks.adil_regularized import learn_coding_vectors
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import dict_apply, fused_adamw_project, fused_perturb
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    victim = create_model(model, input_size=size, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(11)
    n_train = max(n_det, n_adamw, n_sadil)
    images = torch.rand((n_train + n_val + n_serve, size, size, 3), generator=g, device=dev)
    probs = _top1_probability(victim, images)
    print(f"adilr on {model} {size}x{size}: K={ADILR_K}, lambda_l1 = lambda_l2 = 0.1, budget "
          f"10/255, targeted CE, 100 trials; clean top-1 probability median "
          f"{float(probs.median()):.6f}")
    if float(probs.median()) >= 1.0 - 1e-6:
        # CE saturates: no gradient, and the prox solvers' Lipschitz
        # estimate divides by gradient differences.
        gap, probs = _temper(victim, images)
        print(f"  CE saturates: classifier divided by the median top-2 logit gap {gap:.4f} (the "
              f"baselines' tempering); top-1 probability median now {float(probs.median()):.6f}")
    labels = victim.predict(images)
    host = (images.cpu().numpy(), labels.cpu().numpy())
    train = lambda count: (host[0][:count], host[1][:count])
    val = (host[0][n_train:n_train + n_val], host[1][n_train:n_train + n_val])
    served = images[n_train + n_val:]
    served_labels = labels[n_train + n_val:]
    print(f"  {labels.unique().numel()} distinct labels in {images.shape[0]} images; depth "
          f"cut: deterministic steps 100 -> {det_steps} on {n_det} images, adamw "
          f"{adamw_epochs} epochs on {n_adamw} at b{b_adamw}, sadil_updated 1 epoch on "
          f"{n_sadil} at b{b_sadil}")
    perturb_total = adamw_total = 0
    with tempfile.TemporaryDirectory() as root:
        runs = [  # (version, options, fused_adamw_project launches the path makes)
            ("deterministic", dict(steps=det_steps, data_train=train(n_det)), 0),
            ("adamw", dict(steps=adamw_epochs, batch_size=b_adamw, data_train=train(n_adamw),
                           data_val=val), 2 * adamw_epochs * -(-n_adamw // b_adamw)),
            ("sadil_updated", dict(steps=1, batch_size=b_sadil, data_train=train(n_sadil)), 0),
        ]
        for version, options, want in runs:
            torch.cuda.synchronize()
            _zero_counts()
            attack, wall = _timed_run(lambda: ADILR(
                victim, version=version, n_atoms=ADILR_K, cache=ArtifactCache(f"{root}/{version}"),
                model_name=model, **options))
            launches = (fused_perturb.launches, fused_adamw_project.launches)
            saved = ArtifactCache(f"{root}/{version}").load(
                "ADILR", model=model, lam1=0.1, lam2=0.1, atoms=ADILR_K, steps=options["steps"],
                tag="param_selecting")
            loss = saved["loss"][np.isfinite(saved["loss"])]
            extra = (f", fooling {attack.fooling_rates}, val fooling {attack.val_fools}"
                     if version == "adamw" else "")
            print(f"adilr learn {version}: wall {wall:.3f} s, {attack.stats}, final loss "
                  f"{float(loss[-1]):.6f} (losses {np.round(loss, 4).tolist()}), fused_perturb / "
                  f"fused_adamw_project launches {launches[0]} / {launches[1]}{extra}")
            if saved["d"].shape != (ADILR_K, size, size, 3) or not (
                    np.isfinite(saved["d"]).all() and np.isfinite(saved["v"]).all()):
                raise AssertionError(f"adilr {version}: bad artifact")
            if launches[1] != want:
                raise AssertionError(f"adilr {version}: {launches[1]} fused_adamw_project "
                                     f"launches, the path makes {want}")
            adamw_total += launches[1]

        # Serving from the AdamW dictionary, whose codes the Laplace fits
        # read (the prox solvers' stay 0 where every code gradient is under
        # lambda_l1), supervised and unsupervised.
        cache = ArtifactCache(f"{root}/adamw")
        kw = dict(n_atoms=ADILR_K, steps=adamw_epochs, cache=cache, model_name=model)
        sup = ADILR(victim, **kw)
        d = sup._load_dictionary()
        with torch.no_grad():
            targets = torch.argsort(victim(served), dim=-1, stable=True)[:, -2]
        _, wall = _timed_run(lambda: val_fooled(victim, d, val, AdilConfig(
            eps=sup.cfg.eps, n_atoms=ADILR_K, targeted=True, batch_size=n_val), dev))
        print(f"  adamw's per-epoch validation alone (100 AdamW code steps at b{n_val}): "
              f"{wall:.3f} s")
        codes = torch.zeros((n_serve, ADILR_K), device=dev, requires_grad=True)
        ce = torch.nn.functional.cross_entropy(
            victim(served + dict_apply(codes, d)), targets, reduction="sum")
        (grad,) = torch.autograd.grad(ce, codes)
        print(f"  the codes' gradient at v = 0: max |g| {float(grad.abs().max()):.3e} against "
              f"lambda_l1 = {sup.cfg.lambda_l1} (a code moves off 0 only where |g| is larger)")
        learn_coding_vectors(victim, d, served, targets, sup.cfg, niter=2)  # warm-up
        torch.cuda.synchronize()
        _zero_counts()
        adv, wall = _timed_run(lambda: sup(served, served_labels))
        launches = fused_perturb.launches
        linf = float((adv - served).abs().max())
        adv_pred = victim.predict(adv)
        print(f"adilr serve supervised b{n_serve}: wall {wall:.3f} s, learn_coding_vectors "
              f"{sup.stats}, fused_perturb launches {launches}, fooled share "
              f"{float((adv_pred != served_labels).float().mean()):.4f}, on target "
              f"{float((adv_pred == targets).float().mean()):.4f}, |adv - x|_inf {linf:.6f}")
        if launches != 1:
            raise AssertionError(f"adilr supervised: {launches} fused_perturb launches, not 1")
        if not (bool(torch.isfinite(adv).all()) and float(adv.min()) >= 0
                and float(adv.max()) <= 1 and linf <= ADILR_BUDGET + 1e-5):
            raise AssertionError("adilr supervised: adversaries leave [0, 1] or the budget")
        perturb_total += launches
        print_device_breakdown(f"adilr supervised b{n_serve}",
                               lambda: sup(served, served_labels), wall)

        unsup = ADILR(victim, attack="unsupervised", data_train=train(n_adamw), **kw)
        unsup(served, served_labels)  # warm-up
        for mode in ADILR.CONDITIONING:
            unsup.attack_conditioned = mode
            torch.cuda.synchronize()
            _zero_counts()
            adv, wall = _timed_run(lambda: unsup(served, served_labels))
            launches = fused_perturb.launches
            print(f"adilr serve unsupervised {mode} b{n_serve}: wall {wall:.3f} s, fused_perturb "
                  f"launches {launches}, fooled share "
                  f"{float((victim.predict(adv) != served_labels).float().mean()):.4f}, mse "
                  f"{float(((adv - served) ** 2).sum((1, 2, 3)).mean()):.6f}")
            if launches != unsup.cfg.trials:
                raise AssertionError(f"adilr {mode}: {launches} launches, not one a trial")
            if not (bool(torch.isfinite(adv).all()) and float(adv.min()) >= 0
                    and float(adv.max()) <= 1):
                raise AssertionError(f"adilr {mode}: adversaries leave [0, 1]")
            perturb_total += launches
        print_device_breakdown(f"adilr unsupervised {mode} b{n_serve}",
                               lambda: unsup(served, served_labels), wall)
    print(f"adilr: fused_perturb / fused_adamw_project launches {perturb_total} / {adamw_total}")
    if perturb_total == 0 or adamw_total == 0:
        raise AssertionError("adilr: a kernel of the path was never launched")
    rows = check_kernels_at_adilr_shapes(dev)
    check_adilr_against_cpu(dev)
    return perturb_total, adamw_total, rows


GRID_EPS, GRID_ALPHA = 8 / 255, 2 / 255
# The families held on the card against the CPU on the tiny victim.
GRID_FAMILIES = ("pgd", "mifgsm", "difgsm", "cw", "apgd", "apgdt", "fab", "square",
                 "one_pixel", "autoattack")


def _float64_copy(victim):
    """``victim``'s classifier in float64 on a float64 copy of its net and
    normalization, promoting its input to float64."""
    import copy

    net = copy.deepcopy(victim.net).double()
    norm = None if victim.norm is None else copy.deepcopy(victim.norm).double()

    def model(z):
        z = z.permute(0, 3, 1, 2).double()
        return net(z if norm is None else norm(z))

    return model


def grid_family_run(name: str, victim, images, labels):
    """One family of the torchattacks grid on ``victim`` with draws from a
    seeded host generator (so the card and the CPU get the same ones): the adversaries on the host and the decisions it counts (APGD's
    step sizes after each checkpoint, FAB's found flags and chosen
    candidates, Square's queries and accepts, OnePixel's generations and
    accepts, AutoAttack's robust masks). 5 steps, 50 queries, 3
    generations.

    Square runs on a float64 copy of the victim with the margin objective:
    its strict-improvement test meets candidates (a 3x3 square late in the
    schedule, or one that only re-rounds the current best) that move the
    objective by about one float32 ulp, and the attack takes its
    objectives in float32 from the logits, as the JAX package does. In
    float32 the card's logits are about 1e-7 from the CPU's, and the card's
    float32 log-softmax rounds otherwise than the CPU's, so with either the
    two accept different such candidates; the margin of float64 logits
    cast to float32 is the same float on both. (The CE objective is held
    against the JAX package on the CPU, and runs on the card in the
    ResNet-50 row.)"""
    from dl_attack_on_imagenet_tpu_torch.attacks import (
        APGD, APGDT, AutoAttack, apgd, cw, fab, fgsm_family, one_pixel, pgd, square)

    g = torch.Generator().manual_seed(0)
    stats = {}
    eps, alpha, steps = GRID_EPS, GRID_ALPHA, 5
    if name == "pgd":
        adv = pgd.pgd(victim, images, labels, eps, alpha, steps,
                      delta0=pgd.linf_start(g, images.shape, eps))
    elif name == "mifgsm":
        adv = fgsm_family.mifgsm(victim, images, labels, eps, alpha, 1.0, steps)
    elif name == "difgsm":
        size = images.shape[1]
        draws = fgsm_family.diversity_draws(g, size, int(size * 0.9), 0.5, steps)
        adv = fgsm_family.difgsm(victim, images, labels, eps, alpha, 0.0, steps, draws)
    elif name == "cw":
        adv = cw.cw_l2(victim, images, labels, 1.0, 0.0, 0.01, steps)
    elif name == "apgd":
        adv, _ = apgd.apgd(victim, images, labels, eps, steps, loss="ce",
                           u=apgd.start_draw(g, images.shape, "linf"), stats=stats)
    elif name == "apgdt":
        atk = APGDT(victim, steps=steps, n_classes=4)
        adv = atk.forward(images, labels, draws=atk.draws(images.shape, 10), stats=stats)
    elif name == "fab":
        adv, _, found = fab._fab_run(victim, images, labels, images, labels, steps, 9, False,
                                     stats)
        stats["found"] = found.cpu().numpy()
    elif name == "square":
        adv, _ = square.square_linf(_float64_copy(victim), images, labels, eps, 50,
                                    square.query_draws(g, images.shape, 50), loss="margin",
                                    stats=stats)
    elif name == "one_pixel":
        n, c = images.shape[0], images.shape[-1]
        draws = one_pixel.evolution_draws(g, n, 10, 2 * (2 + c), 3)
        adv, _, _ = one_pixel.one_pixel_de(victim, images, labels, steps=3, pixels=2, pop=10,
                                           inf_batch=32, targeted=False, draws=draws,
                                           stats=stats)
    elif name == "autoattack":
        atk = AutoAttack(victim, steps=steps, n_queries=50)
        adv = atk.forward(images, labels, stats=stats)
    else:
        raise ValueError(name)
    return adv.detach().cpu(), stats


def _same_decisions(a, b) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(_same_decisions(x, y) for x, y in zip(a, b))
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def check_grid_against_cpu(dev) -> dict:
    """Every family of the grid on the tiny victim at 32x32 on the card
    against the CPU, with the same host draws, under deterministic cuDNN:
    the adversaries within 1e-4 and every decision count equal. Returns
    each family's max_abs_err."""
    from dl_attack_on_imagenet_tpu_torch.models import create_model

    cpu = torch.device("cpu")
    victim_cpu = create_model("tiny", device=cpu, seed=1)
    victim_dev = create_model("tiny", device=dev, state_dict=victim_cpu.net.state_dict())
    images = torch.rand((8, 32, 32, 3), generator=torch.Generator().manual_seed(5))
    labels = victim_cpu.predict(images)
    errs, bad = {}, []
    with _deterministic_cudnn():
        for name in GRID_FAMILIES:
            adv_cpu, stats_cpu = grid_family_run(name, victim_cpu, images, labels)
            adv_dev, stats_dev = grid_family_run(name, victim_dev, images.to(dev), labels.to(dev))
            errs[name] = float((adv_dev - adv_cpu).abs().max())
            same = stats_cpu.keys() == stats_dev.keys() and all(
                _same_decisions(stats_cpu[k], stats_dev[k]) for k in stats_cpu)
            if not (errs[name] <= 1e-4 and same):
                bad.append(name)
            counts = {k: (len(v) if isinstance(v, list) else
                          int(np.sum(v)) if np.ndim(v) else int(v)) for k, v in stats_cpu.items()}
            print(f"  grid {name} card vs CPU: max_abs_err {errs[name]:.3e} (tol 1e-4), "
                  f"decisions {'equal' if same else 'DIFFER'} {counts}")
    if bad:
        raise AssertionError(f"the grid on the card disagrees with the CPU: {bad}")
    return errs


def _grid_attacks(victim):
    """(label, build(warm) -> attack, bounded) for each row of the reference
    grid at this phase's cuts; ``build(True)`` is the warm-up, the same
    attack at the same batch with its budget cut to one step or query
    where a full warm-up would double a long run."""
    from dl_attack_on_imagenet_tpu_torch.attacks import (
        APGD, APGDT, BIM, CW, DIFGSM, EOTPGD, FAB, FFGSM, FGSM, GN, MIFGSM, PGD, RFGSM, TPGD,
        VANILA, AutoAttack, OnePixel, Square)

    eps, a, steps = GRID_EPS, GRID_ALPHA, 5
    return [
        ("vanila", lambda warm: VANILA(victim), True),
        ("gn sigma=0.1", lambda warm: GN(victim, sigma=0.1), False),
        ("fgsm", lambda warm: FGSM(victim, eps=eps), True),
        ("ffgsm alpha=10/255", lambda warm: FFGSM(victim, eps=eps, alpha=10 / 255), True),
        ("rfgsm", lambda warm: RFGSM(victim, eps=eps, alpha=a, steps=steps), True),
        ("pgd", lambda warm: PGD(victim, eps=eps, alpha=a, steps=steps), True),
        ("bim", lambda warm: BIM(victim, eps=eps, alpha=a, steps=steps), True),
        ("mifgsm decay=0.1", lambda warm: MIFGSM(victim, eps=eps, alpha=a, steps=steps,
                                                 decay=0.1), True),
        ("tpgd", lambda warm: TPGD(victim, eps=eps, alpha=a, steps=steps), True),
        ("eotpgd eot_iter=2", lambda warm: EOTPGD(victim, eps=eps, alpha=a,
                                                  steps=1 if warm else steps, eot_iter=2), True),
        ("difgsm p=0.5 rr=0.9", lambda warm: DIFGSM(victim, eps=eps, alpha=a, steps=steps,
                                                    diversity_prob=0.5, resize_rate=0.9), True),
        ("cw c=1 lr=0.001", lambda warm: CW(victim, c=1.0, steps=steps, lr=0.001), False),
        ("apgd ce", lambda warm: APGD(victim, eps=eps, steps=steps, loss="ce"), True),
        ("apgdt n_classes=10", lambda warm: APGDT(victim, eps=eps, steps=1 if warm else steps,
                                                  n_classes=2 if warm else 10), True),
        ("fab n_classes=10", lambda warm: FAB(victim, eps=eps, steps=1 if warm else 5,
                                              n_classes=10), False),
        ("fab-t n_classes=10", lambda warm: FAB(victim, eps=eps, steps=1 if warm else 5,
                                                n_classes=2 if warm else 10, targeted=True),
         False),
        ("square ce", lambda warm: Square(victim, eps=eps, n_queries=2 if warm else 100,
                                          loss="ce"), True),
        ("onepixel pixels=5 inf_batch=50", lambda warm: OnePixel(
            victim, pixels=5, inf_batch=50, steps=0 if warm else 10), False),
        ("autoattack Linf n_classes=1000", lambda warm: AutoAttack(
            victim, norm="Linf", eps=eps, n_classes=1000, steps=1 if warm else steps,
            n_queries=2 if warm else 50), True),
    ]


def torchattacks_grid(dev, model: str = "resnet50", size: int = 224, n: int = 64) -> dict:
    """The reference's torchattacks grid (``benchmarks/baseline_suite_bench.py``)
    on ResNet-50 at 224x224, batch 64, eps 8/255 and alpha 2/255, the
    classifier tempered; each row after a warm-up, with its wall, fooled
    share and largest l∞ distance; the bounds ([0, 1], the budget of each
    fixed-budget attack, AutoAttack's budget where it changed an image);
    PGD and Square traced; then every family on the card against the CPU.
    The path launches neither kernel, which it checks. Returns each row's
    wall. (The keyword arguments shrink the run for a rehearsal on the
    CPU.)"""
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project, fused_perturb

    _zero_counts()
    victim = create_model(model, input_size=size, device=dev, seed=0)
    images = torch.rand((n, size, size, 3), generator=torch.Generator(device=dev).manual_seed(11),
                        device=dev)
    gap, probs = _temper(victim, images)
    labels = victim.predict(images)
    print(f"torchattacks grid on {model} {size}x{size}, b{n}, eps 8/255, alpha 2/255, fp32: "
          f"classifier divided by the median top-2 logit gap {gap:.4f}; clean top-1 probability "
          f"median {float(probs.median()):.6f}, {labels.unique().numel()} distinct labels. Cuts "
          "of depth: 100 -> 5 steps for the gradient attacks (EOTPGD eot_iter=2, DIFGSM p=0.5 "
          "rr=0.9, MIFGSM decay=0.1), CW c=1 lr=0.001 at 5 steps, APGD-CE and APGD-T "
          "(n_classes=10) at 5 steps, FAB and FAB-T (n_classes=10) at 5, Square (ce) at 100 "
          "queries of 5000, OnePixel pixels=5 inf_batch=50 at its default 10 generations, "
          "AutoAttack (Linf, n_classes=1000) at 5 steps and 50 Square queries")
    walls, traced = {}, {"pgd": None, "square ce": None}
    for label, build, bounded in _grid_attacks(victim):
        build(True)(images, labels)  # warm-up
        attack = build(False)
        adv, wall = _timed_run(lambda: attack(images, labels))
        walls[label] = wall
        dist = (adv - images).abs().flatten(1).amax(1)
        print(f"grid {label}: wall {wall:.3f} s, fooled share "
              f"{_fooled_share(victim, adv, images):.4f}, l∞ max {float(dist.max()):.6f}")
        if adv.shape != images.shape or not bool(torch.isfinite(adv).all()) or not (
                float(adv.min()) >= 0 and float(adv.max()) <= 1):
            raise AssertionError(f"grid {label}: adversaries leave [0, 1]")
        if bounded and not float(dist.max()) <= GRID_EPS + 1e-5:
            raise AssertionError(f"grid {label}: l∞ budget broken: {float(dist.max())}")
        if label in traced:
            print_device_breakdown(f"grid {label}", lambda: attack(images, labels), wall)
    errs = check_grid_against_cpu(dev)
    launches = (fused_perturb.launches, fused_adamw_project.launches)
    print(f"torchattacks grid: {sum(walls.values()):.1f} s in the timed rows; fused_perturb / "
          f"fused_adamw_project launches {launches[0]} / {launches[1]} (the path runs neither "
          f"kernel); card vs CPU max_abs_err {max(errs.values()):.3e}")
    if launches != (0, 0):
        raise AssertionError(f"torchattacks grid launched a kernel: {launches}")
    return walls


# -- the tenth slice: cli.generate, cli.import_artifacts, the S2D layout --


def _layouts_close(name: str, got, want, start, spread=None, tol: float = 0.1) -> float:
    """Hold the blocked layout's result against the standard one's, both
    moved from ``start``: their moves within ``tol`` in relative l2. On a
    random ResNet-50 at 224x224 the two layouts' input gradients part by
    about 0.5% in l2 (max-pool windows whose top two values are within
    rounding route to other inputs, as the card and the CPU do with one
    layout), and signed steps carry that into the state, so no elementwise
    bound holds; a wrong column order would give about 1.4. ``spread``, the
    same distance between two standard runs without deterministic cuDNN,
    is printed beside it. Returns the distance."""
    move = (torch.as_tensor(want) - torch.as_tensor(start)).float()
    diff = (torch.as_tensor(got) - torch.as_tensor(want)).float()
    rel = float(diff.norm() / move.norm())
    extra = f"; two standard runs without deterministic cuDNN {spread:.3e}" if spread else ""
    print(f"  {name}: the moves {rel:.3e} apart in relative l2 (tol {tol:g}), max_abs_diff "
          f"{float(diff.abs().max()):.3e}{extra}")
    if not rel <= tol:
        raise AssertionError(f"{name}: the two layouts part: {rel}")
    return rel


def check_kernels_at_new_shapes(dev, n: int = 128, k: int = 100, h: int = 224):
    """``fused_perturb`` at N=128, the batch ``cli.generate`` serves, and both
    kernels on the space-to-depth layout (D and x blocked, the columns
    permuted), each against its plain twin, timed beside the twin and the
    bound. Returns the (fused_perturb, fused_adamw_project) rows."""
    from dl_attack_on_imagenet_tpu_torch.models import space_to_depth
    from dl_attack_on_imagenet_tpu_torch.ops import (
        fused_adamw_project, fused_adamw_project_reference, fused_perturb,
        fused_perturb_reference)

    g = torch.Generator(device=dev).manual_seed(8)
    m = h * h * 3
    d = torch.rand((k, h, h, 3), generator=g, device=dev) * 2 - 1
    x = torch.rand((n, h, h, 3), generator=g, device=dev)
    v = torch.randn((n, k), generator=g, device=dev) * 0.01
    d_b, x_b = space_to_depth(d), space_to_depth(x)

    def plain(v_, d_, x_, eps):
        return fused_perturb_reference(v_, d_.reshape(k, -1), x_.reshape(x_.shape[0], -1),
                                       eps).reshape(x_.shape)

    rows = {}
    for label, (dd, xx) in (("n128", (d, x)), ("blocked", (d_b, x_b))):
        err = max(float((fused_perturb(v, dd, xx, eps) - plain(v, dd, xx, eps)).abs().max())
                  for eps in (EPS, float("inf")))
        ms = _time_ms(lambda: fused_perturb(v, dd, xx, EPS))
        plain_ms = _time_ms(lambda: plain(v, dd, xx, EPS))
        bound_ms, bound_by = fused_perturb_bound_ms(n, k, m)
        rows[label] = {"shape": [n, k, m], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                       "bound_share": bound_ms / ms}
        print(f"fused_perturb [{label}: N={n} K={k} M={m}, D {tuple(dd.shape)}]: max_abs_err "
              f"{err:.3e} (tol 1e-5), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of it)")
        if not err <= 1e-5:
            raise AssertionError(f"fused_perturb [{label}] disagrees with its twin: {err}")
    same = float((space_to_depth(fused_perturb(v, d, x, EPS)) - fused_perturb(v, d_b, x_b, EPS))
                 .abs().max())
    print(f"  blocked against the unblocked launch, blocked afterwards: max_abs_diff {same:.3e}")
    if not same <= 1e-6:
        raise AssertionError(f"fused_perturb on the blocked layout is not the permuted result: {same}")

    def adamw_inputs(flat):
        gg = torch.Generator(device=dev).manual_seed(9)
        return (torch.rand(flat.shape, generator=gg, device=dev) * 2.4 - 1.2,
                torch.randn(flat.shape, generator=gg, device=dev) * 1e-3,
                torch.randn(flat.shape, generator=gg, device=dev) * 1e-4,
                torch.rand(flat.shape, generator=gg, device=dev) * 1e-6)

    d_flat = space_to_depth(d).reshape(k, -1)
    args = adamw_inputs(d_flat)
    want = fused_adamw_project_reference(*args, 3, 0.01, clip_val=1.0)
    got = [t.clone() for t in args]
    fused_adamw_project(*got, 3, 0.01, 1.0)
    err = max(float((got[0] - want[0]).abs().max()), float((got[2] - want[1]).abs().max()),
              float(((got[3] - want[2]).abs() / want[2].abs().clamp_min(1e-30)).max()))
    scratch = [t.clone() for t in args]
    ms = _time_ms(lambda: fused_adamw_project(*scratch, 3, 0.01, 1.0))
    plain_ms = _time_ms(lambda: fused_adamw_project_reference(*scratch, 3, 0.01))
    bound_ms, bound_by = fused_adamw_project_bound_ms(d_flat.numel())
    print(f"fused_adamw_project [blocked D {tuple(d_flat.shape)} in the space-to-depth column "
          f"order]: max_abs_err {err:.3e} (tol 1e-6; nu relative), kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not err <= 1e-6:
        raise AssertionError(f"fused_adamw_project on the blocked layout disagrees: {err}")
    adamw_row = {"blocked": {"shape": list(d_flat.shape), "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": None, "bound_share": bound_ms / ms}}
    return rows, adamw_row


def _save_dictionary(dev, cache, model: str, size: int, k: int = 100):
    """A seeded projected random dictionary of ``k`` atoms for ``model``."""
    from dl_attack_on_imagenet_tpu_torch.attacks.adil_core import AdilConfig, init_dictionary
    from dl_attack_on_imagenet_tpu_torch.ops import project_dictionary

    g = torch.Generator(device=dev).manual_seed(0)
    d = project_dictionary(init_dictionary(g, (size, size, 3), AdilConfig(n_atoms=k)))
    cache.save({"d": d}, "ImageNet", model=model)


def _jpeg_tree(root: str, n: int) -> str:
    """``n`` seeded 300x260 JPEGs in two class folders of an ILSVRC tree."""
    from PIL import Image

    rng = np.random.default_rng(4)
    for i in range(n):
        folder = os.path.join(root, "ILSVRC", "Data", "val", f"n0000000{i % 2}")
        os.makedirs(folder, exist_ok=True)
        Image.fromarray((rng.random((260, 300, 3)) * 255).astype(np.uint8)).save(
            os.path.join(folder, f"{i}.JPEG"))
    return root


def _read_report(out: str):
    with open(os.path.join(out, "report.jsonl")) as f:
        return [json.loads(line) for line in f]


def generate_phase(dev, root: str, model: str = "resnet50", size: int = 224, n: int = 300,
                   batch: int = 128, k: int = 100, steps: int = 30, n_folder: int = 8):
    """``cli.generate`` on ``model`` through its ``main``: a blob of ``n``
    seeded images written by ``cli.dataset``'s writer (two full batches and a
    short one), served supervised (``steps`` DDrague steps), unsupervised
    (10 trials) and once more with ``--save-images --limit batch``; then a
    folder of JPEGs that the phase writes, and one traced batch for the
    busy share. Returns (fused_perturb launches, the blob, the dictionary
    directory, the tempered weights)."""
    from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
    from dl_attack_on_imagenet_tpu_torch.cli import dataset, generate
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import fused_perturb
    from dl_attack_on_imagenet_tpu_torch.runtime import get_runtime, host_loader
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    dicts = os.path.join(root, "dicts")
    _save_dictionary(dev, ArtifactCache(dicts), model, size, k)
    t0 = time.perf_counter()
    images = np.random.default_rng(5).random((n, size, size, 3), dtype=np.float32)
    blob = os.path.join(root, "blob.npz")
    dataset.save_blob(blob, images, np.zeros(n), ["synthetic"])
    print(f"generate: blob of {n} seeded images at {size}x{size} written by cli.dataset.save_blob "
          f"({os.path.getsize(blob) / 1e6:.1f} MB, {time.perf_counter() - t0:.1f} s)")
    # The seed-0 net's softmax is 1 in fp32, where the CLI's CE loss has no
    # gradient and DDrague stops after one step: the CLI gets the tempered
    # net (as the baselines' phase tempers it) through --weights.
    victim = create_model(model, input_size=size, device=dev, seed=0)
    gap, top1 = _temper(victim, torch.as_tensor(images[:batch], device=dev))
    weights = os.path.join(root, f"{model}_tempered.pt")
    torch.save({name: t.cpu() for name, t in victim.net.state_dict().items()}, weights)
    print(f"generate: the classifier divided by the median top-2 logit gap {gap:.2f}; clean "
          f"top-1 probability median {float(top1.median()):.4f}")
    common = ["--model", model, "--dict-dir", dicts, "--device", str(dev), "--input-size",
              str(size), "--steps-inference", str(steps), "--batch-size", str(batch),
              "--weights", weights]
    n_batches = -(-n // batch)
    runs = [  # (name, flags, rows served, launches a batch)
        ("supervised", ["--blob", blob], n, 1),
        ("unsupervised", ["--blob", blob, "--mode", "unsupervised"], n, 10),
        ("supervised --save-images", ["--blob", blob, "--save-images", "--limit", str(batch)],
         batch, 1),
        ("supervised folder", ["--data-root", _jpeg_tree(os.path.join(root, "jpegs"), n_folder)],
         n_folder, 1),
    ]
    total, summaries = 0, {}
    for name, flags, rows, per_batch in runs:
        if "folder" in name:
            print("generate folder path: " + ("the native loader" if get_runtime() is not None
                  else "PIL decodes (the native loader did not build: "
                       f"{(host_loader.build_error or '').strip().splitlines()[-1:]})"))
        out = os.path.join(root, name.replace(" ", "_").replace("-", ""))
        args = generate.build_argparser().parse_args(common + flags + ["--out-dir", out])
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        summary = generate.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_perturb.launches
        report = _read_report(out)
        want_batches = -(-rows // batch)
        print(f"generate {name}: wall {wall:.2f} s (victim build included), "
              f"{summary['images_per_sec']:.2f} images/s in the summary, fooling rate "
              f"{summary['fooling_rate']:.4f}, fused_perturb launches {launches} "
              f"({per_batch} a batch)")
        for r in report:
            print(f"  batch at {int(r['step'])}: {int(r['n'])} images, {r['seconds']:.3f} s, "
                  f"{r['n'] / r['seconds']:.2f} images/s, fooling {r['fooling']:.4f}, "
                  f"mse {r['mse']:.6f}")
        if summary["total"] != rows or len(report) != want_batches:
            raise AssertionError(f"generate {name}: {summary['total']} rows in {len(report)} "
                                 f"batches, not {rows} in {want_batches}")
        if launches != per_batch * want_batches:
            raise AssertionError(f"generate {name}: {launches} launches, the path makes "
                                 f"{per_batch * want_batches}")
        if not all(np.isfinite(r["mse"]) and 0 <= r["fooling"] <= 1 for r in report):
            raise AssertionError(f"generate {name}: bad report {report}")
        if "save-images" in name:
            from PIL import Image

            pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
            first = np.asarray(Image.open(os.path.join(out, pngs[0])))
            print(f"  {len(pngs)} PNGs, {pngs[0]} of shape {first.shape} {first.dtype}")
            if len(pngs) != batch or first.shape != (size, size, 3):
                raise AssertionError(f"generate {name}: {len(pngs)} PNGs of {first.shape}")
        total += launches
        summaries[name] = summary
    # One batch again, traced, for the busy share against the second
    # supervised batch's wall.
    attack = ADIL(victim, eps=EPS, model_name=model, steps_inference=steps,
                  cache=ArtifactCache(dicts))
    x = torch.as_tensor(images[:batch], device=dev)
    wall = _read_report(os.path.join(root, "supervised"))[min(1, n_batches - 1)]["seconds"]
    print_device_breakdown("generate supervised batch", lambda: attack(x, None), wall)
    return total, blob, dicts, weights


def trace_phase(dev, root: str, blob: str, dicts: str, weights: str, model: str = "resnet50",
                size: int = 224, batch: int = 128, steps: int = 5):
    """One ``cli.generate`` batch (``steps`` DDrague steps) inside
    ``utils.trace``: the trace file is written and holds CUDA kernels."""
    from dl_attack_on_imagenet_tpu_torch.cli import generate
    from dl_attack_on_imagenet_tpu_torch.utils import trace

    log_dir = os.path.join(root, "trace")
    args = generate.build_argparser().parse_args([
        "--model", model, "--blob", blob, "--dict-dir", dicts, "--device", str(dev),
        "--input-size", str(size), "--steps-inference", str(steps), "--limit", str(batch),
        "--weights", weights, "--out-dir", os.path.join(root, "traced")])
    t0 = time.perf_counter()
    with trace(log_dir):
        generate.main(args)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"trace: one generate batch of {batch} ({steps} DDrague steps) traced in {wall:.1f} s "
          f"into {path} ({os.path.getsize(path) / 1e6:.1f} MB, {len(events)} events, "
          f"{kernels} CUDA kernels)")
    if dev.type == "cuda" and not kernels:
        raise AssertionError("trace: no CUDA kernel in the trace")


def import_phase(dev, root: str, model: str = "resnet50", size: int = 224, k: int = 100,
                 n_train: int = 128, n: int = 64) -> int:
    """Reference-format artifacts written with ``torch.save`` (ADIL's ``[d
    (C,H,W,K), v, loss, fooling, val]``, UAP-PGD's ``[e (1,C,H,W),
    fooling]``), imported by ``cli.import_artifacts``, and served: one
    supervised batch of ``n`` from the imported dictionary (CW loss, 30
    DDrague steps, as the serve phase), one UAP-PGD batch. Returns the
    fused_perturb launches of the served batch."""
    from dl_attack_on_imagenet_tpu_torch.attacks import ADIL, UAPPGD
    from dl_attack_on_imagenet_tpu_torch.cli import import_artifacts
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import fused_perturb
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    g = torch.Generator().manual_seed(7)
    d_ref = torch.rand((3, size, size, k), generator=g) * 2 - 1
    v_ref = torch.rand((n_train, k), generator=g) * 0.01
    e_ref = (torch.rand((1, 3, size, size), generator=g) * 2 - 1) * 0.03
    adil_src, uap_src = os.path.join(root, "ImageNet_ref.bin"), os.path.join(root, "attack.bin")
    torch.save([d_ref, v_ref, [0.5, 0.4], [0.1, 0.2], 0.3], adil_src)
    torch.save([e_ref, [0.2]], uap_src)
    dicts = os.path.join(root, "imported")
    t0 = time.perf_counter()
    for kind, src in (("adil", adil_src), ("uappgd", uap_src)):
        import_artifacts.main(["--kind", kind, "--src", src, "--model", model, "--cache", dicts])
    print(f"import: two reference artifacts imported in {time.perf_counter() - t0:.2f} s")
    cache = ArtifactCache(dicts)
    d = cache.load("ImageNet", model=model)["d"]
    e = cache.load("UAPPGD", model=model)["e"]
    if not (np.array_equal(d, d_ref.permute(3, 1, 2, 0).numpy())
            and np.array_equal(e, e_ref.permute(0, 2, 3, 1).numpy())):
        raise AssertionError("import: the layouts were not converted")
    victim = create_model(model, input_size=size, device=dev, seed=0)
    images = torch.rand((n, size, size, 3), generator=torch.Generator(device=dev).manual_seed(6),
                        device=dev)
    attack = ADIL(victim, eps=EPS, n_atoms=k, loss="logits", cache=cache)
    if not attack.is_trained:
        raise AssertionError("import: ADIL does not find the imported dictionary")
    attack(images[:2], None)  # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    adv = attack(images, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_perturb.launches
    fooled = float((victim.predict(adv) != victim.predict(images)).float().mean())
    print(f"import: served a supervised batch of {n} from the imported dictionary in {wall:.2f} s, "
          f"fooling {fooled:.4f}, fused_perturb launches {launches}")
    if launches != 1 or not (bool(torch.isfinite(adv).all()) and 0 <= float(adv.min())
                             and float(adv.max()) <= 1):
        raise AssertionError(f"import: bad serve ({launches} launches)")
    uap = UAPPGD(victim, cache=cache)
    err = float((uap(images, None) - (images + torch.as_tensor(e, device=dev)).clamp(0, 1))
                .abs().max())
    print(f"import: UAP-PGD serves the imported perturbation: max_abs_err {err:.3e}")
    if not err == 0.0:
        raise AssertionError(f"import: UAP-PGD does not serve the imported e: {err}")
    return launches


def check_s2d_stems(dev, model: str = "resnet50", size: int = 224) -> None:
    """The S2D stem on the card, batch 2. The stem alone (conv and
    BatchNorm on the space-to-depth blocks, ``models.resnet.s2d_stem``)
    against the plain ``conv1``/``bn1``: its output and its input gradient
    under a random cotangent within 1e-5 of their largest values. Then the
    whole ``model`` built with ``stem_s2d``, built as ``--fast-victim``
    builds it (``stem_s2d``, then the BatchNorm fold) and its blocked twin,
    each against the plain stem on the card and against the same build on
    the CPU: logits within 1e-4 of the largest logit, and the CW input
    gradient (at the predicted labels, as an attack takes it) within twice
    the relative l2 distance of the plain stem's own card and CPU runs
    (at least 1e-3). Not elementwise: at 224x224 some max-pool windows of
    a random ResNet-50 hold two values within rounding, and two summation
    orders then route the window's gradient to different inputs; the plain
    stem's card and CPU runs part that way too, and their distance is
    printed."""
    from dl_attack_on_imagenet_tpu_torch.models import (
        blocked_twin, create_model, depth_to_space, space_to_depth)
    from dl_attack_on_imagenet_tpu_torch.models.fold import fold_victim
    from dl_attack_on_imagenet_tpu_torch.models.layers import space_to_depth_nchw
    from dl_attack_on_imagenet_tpu_torch.models.resnet import s2d_stem
    from dl_attack_on_imagenet_tpu_torch.ops import attack_loss

    cpu = torch.device("cpu")
    plain = create_model(model, input_size=size, device=cpu, seed=0)
    sd = plain.net.state_dict()
    x = torch.rand((2, size, size, 3), generator=torch.Generator().manual_seed(3))
    labels = plain.predict(x)

    on_dev = create_model(model, input_size=size, device=dev, state_dict=sd)
    xn = on_dev.norm(x.to(dev).permute(0, 3, 1, 2)).contiguous(memory_format=torch.channels_last)
    net = on_dev.net
    stems = []
    for stem in (lambda t: net.bn1(net.conv1(t)),
                 lambda t: s2d_stem(space_to_depth_nchw(t), net.conv1, net.bn1)):
        xt = xn.clone().requires_grad_(True)
        y = stem(xt)
        co = torch.randn(y.shape, generator=torch.Generator(device=dev).manual_seed(4), device=dev)
        (grad,) = torch.autograd.grad((y * co).sum(), xt)
        stems.append((y.detach(), grad))
    errs = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(*stems)]
    print(f"s2d stem {model} at {size}x{size}, the stem alone on the card: output max_abs_err "
          f"{errs[0]:.3e}, input gradient {errs[1]:.3e}, each of its largest value (tol 1e-5)")
    if not max(errs) <= 1e-5:
        raise AssertionError(f"s2d stem: the blocked stem disagrees with conv1/bn1: {errs}")

    def run(victim, d, blocked=False):
        xt = (space_to_depth(x) if blocked else x).to(d).requires_grad_(True)
        logits = victim(xt)
        (grad,) = torch.autograd.grad(attack_loss(logits, labels.to(d), loss="logits"), xt)
        return logits.detach().cpu(), (depth_to_space(grad) if blocked else grad).cpu()

    def builds(d):
        s2d = create_model(model, input_size=size, device=d, state_dict=sd, stem_s2d=True)
        fast = fold_victim(create_model(model, input_size=size, device=d, state_dict=sd,
                                        stem_s2d=True))
        return {"stem_s2d": run(s2d, d), "--fast-victim": run(fast, d),
                "blocked twin": run(blocked_twin(s2d), d, blocked=True)}

    def errors(out, ref):
        return (float((out[0] - ref[0]).abs().max()),
                float((out[1] - ref[1]).norm() / ref[1].norm()),
                float((out[1] - ref[1]).abs().max()))

    ref = run(on_dev, dev)
    if not float(ref[1].abs().max()) > 0:
        raise AssertionError("s2d stem: the CW input gradient is 0, nothing would be compared")
    floor = errors(ref, run(plain, cpu))
    scale, tol = max(1.0, float(ref[0].abs().max())), max(1e-3, 2 * floor[1])
    print(f"s2d stem {model}: |logits| up to {scale:.3e}, |gradient| up to "
          f"{float(ref[1].abs().max()):.3e}; the plain stem on the card against the CPU: logits "
          f"{floor[0]:.3e}, gradient rel l2 {floor[1]:.3e} (max {floor[2]:.3e})")
    on_card, on_cpu = builds(dev), builds(cpu)
    for name, out in on_card.items():
        errs, cpu_errs = errors(out, ref), errors(out, on_cpu[name])
        print(f"s2d stem {model} {name}: against the plain stem on the card logits "
              f"{errs[0]:.3e}, gradient rel l2 {errs[1]:.3e} (max {errs[2]:.3e}); against the "
              f"CPU logits {cpu_errs[0]:.3e}, gradient rel l2 {cpu_errs[1]:.3e} (max "
              f"{cpu_errs[2]:.3e}) (tol 1e-4 x {scale:.3g}, {tol:.3e})")
        if not all(e[0] <= 1e-4 * scale and e[1] <= tol for e in (errs, cpu_errs)):
            raise AssertionError(f"s2d stem {name} disagrees: {errs} {cpu_errs}")


def blocked_phase(dev, model: str = "resnet50", size: int = 224, n: int = 64, k: int = 100,
                  n_learn: int = 128, n_steps: int = 10):
    """The space-to-depth layout on ``model`` with an S2D stem, each item in
    both layouts with both walls: the stem alone (forward and input
    gradient, CUDA events); 10 chained ``gd`` steps at b64 (timed and
    traced) and 3 more under deterministic cuDNN held against each other;
    a supervised DDrague batch of ``n`` served through the twin; learning
    on ``n_learn`` images at b64 for 2 epochs through ``ADIL`` with
    ``pipeline_epochs`` True and False (D and v within 1e-5 under
    deterministic cuDNN); and data-parallel learning at world size 1 with
    ``blocked=True`` against its serial replay on the twin (1e-5). Returns
    the (fused_perturb, fused_adamw_project) launches."""
    from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
    from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
    from dl_attack_on_imagenet_tpu_torch.models import (
        blocked_twin, create_model, depth_to_space, space_to_depth)
    from dl_attack_on_imagenet_tpu_torch.models.layers import space_to_depth_nchw
    from dl_attack_on_imagenet_tpu_torch.models.resnet import s2d_stem
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project, fused_perturb
    from dl_attack_on_imagenet_tpu_torch.parallel import auto_initialize, data_mesh
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    perturb, adamw = 0, 0
    victim = create_model(model, input_size=size, device=dev, seed=0, stem_s2d=True)
    twin = blocked_twin(victim)
    shape, b_shape = (size, size, 3), (size // 2, size // 2, 12)
    cfg = core.AdilConfig(eps=EPS, n_atoms=k, loss="logits", batch_size=n)
    g = torch.Generator(device=dev).manual_seed(1)
    images = torch.rand((n,) + shape, generator=g, device=dev)
    state0 = core.init_state(g, shape, n, cfg)
    idx, mask = torch.arange(n, device=dev), torch.ones(n, device=dev)

    def layout(blocked: bool):
        state = core.TrainState(**{f: (v.clone() if torch.is_tensor(v) else v)
                                   for f, v in vars(state0).items()})
        if blocked:
            state.d = space_to_depth(core.d_image(state.d, shape)).reshape(k, -1)
            state.d_mu, state.d_nu = torch.zeros_like(state.d), torch.zeros_like(state.d)
            return twin, state, space_to_depth(images)
        return victim, state, images

    # The stem alone at b64: forward and input gradient under a random
    # cotangent, cuDNN's 3-channel 7x7/s2 convolution against the 4x4/s1
    # one over 12 channels (and its pad).
    net = victim.net
    xn = victim.norm(images.permute(0, 3, 1, 2)).contiguous(memory_format=torch.channels_last)
    for name, stem, inp in (("standard", lambda t: net.bn1(net.conv1(t)), xn),
                            ("blocked", lambda t: s2d_stem(t, net.conv1, net.bn1),
                             space_to_depth_nchw(xn))):
        inp = inp.detach().requires_grad_(True)
        co = torch.randn(stem(inp).shape, generator=g, device=dev)
        ms = _time_ms(lambda: torch.autograd.grad((stem(inp) * co).sum(), inp), iters=20)
        print(f"blocked phase: the stem alone {name} at b{n} (input {tuple(inp.shape)}): "
              f"forward and input gradient {ms:.3f} ms")

    walls = {}
    for blocked in (False, True):
        name = "blocked" if blocked else "standard"
        model_, state, xs = layout(blocked)
        labels = core.predict_labels(model_, xs)
        step = core.make_train_step(model_, cfg, "both")
        step(state, xs, labels, idx, mask)  # warm-up
        scan = core.make_train_scan(model_, cfg, "both", n_steps=n_steps)
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        losses, _ = scan(state, xs, labels, idx, mask)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) / n_steps
        launches = fused_adamw_project.launches
        print(f"blocked phase: gd step {name} on {model} (S2D stem) at b{n} K={k} {size}x{size}: "
              f"{walls[name] * 1e3:.2f} ms/step over {n_steps} chained steps, "
              f"fused_adamw_project launches {launches}, loss {float(losses[0]):.4f} -> "
              f"{float(losses[-1]):.4f}")
        if launches != 2 * n_steps or not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"blocked phase {name}: {launches} launches or a bad loss")
        adamw += launches
        print_device_breakdown(f"train step {name}", lambda: step(state, xs, labels, idx, mask),
                               walls[name])
    print(f"blocked phase: gd step blocked/standard {walls['blocked'] / walls['standard']:.3f}")
    def three_steps(blocked: bool):
        model_, state, xs = layout(blocked)
        step = core.make_train_step(model_, cfg, "both")
        labels = core.predict_labels(model_, xs)
        loss = [float(step(state, xs, labels, idx, mask)[0]) for _ in range(3)]
        d = depth_to_space(core.d_image(state.d, b_shape)) if blocked else state.d
        return d.reshape(k, -1), state.v, loss

    spread = three_steps(False)[0]
    with _deterministic_cudnn():
        runs = {blocked: three_steps(blocked) for blocked in (False, True)}
    spread = float((spread - runs[False][0]).norm() / (runs[False][0] - state0.d).norm())
    print(f"blocked phase: 3 gd steps, losses standard {runs[False][2]} blocked {runs[True][2]}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(runs[True][2], runs[False][2]))
    if not loss_err <= 1e-5:
        raise AssertionError(f"blocked phase: the layouts' losses part: {loss_err}")
    _layouts_close("gd steps blocked against standard, D", runs[True][0], runs[False][0],
                   state0.d, spread)
    _layouts_close("gd steps blocked against standard, v", runs[True][1], runs[False][1],
                   state0.v)

    with tempfile.TemporaryDirectory() as root:
        cache = ArtifactCache(root)
        _save_dictionary(dev, cache, victim.name, size, k)
        served = {}
        for blocked in ("auto", False, "again"):
            attack = ADIL(victim, eps=EPS, n_atoms=k, loss="logits", steps_inference=30,
                          cache=cache, blocked=blocked != "again" and blocked)
            if blocked == "again":  # the standard layout once more, for its spread
                served[blocked] = attack(images, None)
                continue
            attack(images, None)  # warm-up
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            served[blocked] = attack(images, None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fused_perturb.launches
            via = "through the twin" if blocked else "standard"
            print(f"blocked phase: supervised DDrague b{n} {via}: wall {wall:.3f} s, "
                  f"fused_perturb launches {launches}")
            if launches != 1:
                raise AssertionError(f"blocked phase serving: {launches} launches")
            perturb += launches
        spread = float((served["again"] - served[False]).norm()
                       / (served[False] - images).norm())
        _layouts_close("DDrague through the twin against standard", served["auto"],
                       served[False], images, spread)

    rs = np.random.default_rng(2)
    data = (rs.random((n_learn,) + shape, dtype=np.float32), np.zeros((n_learn,), np.int64))
    learned, walls = {}, {True: [], False: []}
    with _deterministic_cudnn():
        for pipeline in (False, True, True, False):  # in turns, for the walls
            with tempfile.TemporaryDirectory() as root:
                torch.cuda.synchronize()
                _zero_counts()
                t0 = time.perf_counter()
                attack = ADIL(victim, eps=EPS, n_atoms=k, batch_size=n, loss="logits", steps=2,
                              data_train=data, cache=ArtifactCache(root), seed=0,
                              pipeline_epochs=pipeline)
                torch.cuda.synchronize()
                walls[pipeline].append(time.perf_counter() - t0)
                launches = fused_adamw_project.launches
                v = ArtifactCache(root).load("ImageNet", model=victim.name)["v"]
            print(f"blocked phase: ADIL learning pipeline_epochs={pipeline} (trained blocked: "
                  f"{attack.trained_blocked}), {n_learn} images b{n} 2 epochs: wall "
                  f"{walls[pipeline][-1]:.3f} s (the label pass included), "
                  f"fused_adamw_project launches {launches}")
            want = 2 * 2 * -(-n_learn // n)
            if launches != want or not attack.trained_blocked:
                raise AssertionError(f"blocked phase learning: {launches} launches (the path "
                                     f"makes {want}), blocked {attack.trained_blocked}")
            adamw += launches
            learned.setdefault(pipeline, (attack.dictionary, torch.as_tensor(v),
                                          attack.history["loss"]))
    err = max(float((learned[True][0] - learned[False][0]).abs().max()),
              float((learned[True][1] - learned[False][1]).abs().max()))
    print(f"blocked phase: pipelined against serial: D and v max_abs_err {err:.3e} (tol 1e-5), "
          f"losses {learned[True][2]} / {learned[False][2]}; mean walls {np.mean(walls[True]):.3f}"
          f" / {np.mean(walls[False]):.3f} s")
    if not err <= 1e-5:
        raise AssertionError(f"blocked phase: the pipelined epochs part from the serial: {err}")

    auto_initialize(device=dev)
    mesh = data_mesh()
    with tempfile.TemporaryDirectory() as root, _deterministic_cudnn():
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        attack = ADIL(victim, eps=EPS, n_atoms=k, batch_size=n, loss="logits", steps=2,
                      data_train=data, cache=ArtifactCache(root), mesh=mesh, seed=0,
                      blocked=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_adamw_project.launches
        v = torch.as_tensor(ArtifactCache(root).load("ImageNet", model=victim.name)["v"],
                            device=dev)
        state = _replay(dev, twin, space_to_depth(torch.as_tensor(data[0])), attack.cfg, mesh,
                        1, 2)
    err = max(float((attack.dictionary - depth_to_space(core.d_image(state.d, b_shape)))
                    .abs().max()), float((v - state.v[:n_learn]).abs().max()))
    print(f"blocked phase: ADIL(mesh=data_mesh(), blocked=True) at world size 1: wall {wall:.2f} s, "
          f"blocked {attack.trained_blocked}, fused_adamw_project launches {launches}; against "
          f"the serial replay on the twin: D and v max_abs_err {err:.3e} (tol 1e-5)")
    if not (err <= 1e-5 and attack.trained_blocked and launches == 2 * 2 * -(-n_learn // n)):
        raise AssertionError(f"blocked phase dp: {err}, {launches} launches")
    adamw += launches
    return perturb, adamw


@contextlib.contextmanager
def _kernel_dtypes():
    """Record the dtypes the attack core hands each kernel wrapper while the
    block runs (the wrappers also refuse anything but fp32 on the card)."""
    from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core

    seen = set()
    real = {name: getattr(core, name) for name in ("fused_perturb", "fused_adamw_project")}

    def recorded(name):
        def wrapper(*args, **kwargs):
            seen.update((name, t.dtype) for t in args if torch.is_tensor(t))
            return real[name](*args, **kwargs)
        return wrapper

    for name in real:
        setattr(core, name, recorded(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(core, name, fn)


def _state_copy(state):
    from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core

    return core.TrainState(**{f: (v.clone() if torch.is_tensor(v) else v)
                              for f, v in vars(state).items()})


def _timed_steps(victim, cfg, state, xs, labels, n_steps: int):
    """A warm-up ``gd`` step, then ``n_steps`` chained ones timed with the
    launch counts at 0 before them: (ms a step, fused_adamw_project
    launches, losses)."""
    from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project

    n = xs.shape[0]
    idx, mask = torch.arange(n, device=xs.device), torch.ones(n, device=xs.device)
    core.make_train_step(victim, cfg, "both")(state, xs, labels, idx, mask)
    scan = core.make_train_scan(victim, cfg, "both", n_steps=n_steps)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses, _ = scan(state, xs, labels, idx, mask)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    launches = fused_adamw_project.launches
    if launches != 2 * n_steps or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{launches} launches in {n_steps} steps, or a bad loss {losses}")
    return ms, launches, losses


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm())


def check_bf16_families_against_cpu(dev) -> None:
    """Each family's bf16 victim on the card against the same bf16 victim on
    the CPU at a small input size, batch 2, by the gap rule of the CPU
    tests: the card's bf16 logits and CW input gradient no further from the
    CPU's bf16 ones (relative l2) than those are from the CPU's fp32 ones,
    argmax equal."""
    from dl_attack_on_imagenet_tpu_torch.models import create_model
    from dl_attack_on_imagenet_tpu_torch.ops import attack_loss

    g = torch.Generator().manual_seed(3)
    labels = torch.tensor([1, 3])
    builds = ([("resnet18", 32, {}), ("resnet18", 32, {"stem_s2d": True, "fold_bn": True})]
              + [(name, size, {}) for name, size in SMALL_FAMILIES])
    for name, size, kwargs in builds:
        cpu32 = create_model(name, input_size=size, device="cpu", seed=1)
        weights = cpu32.net.state_dict()
        x = torch.rand((2, size, size, 3), generator=g)
        out = {}
        for tag, d, dtype in (("cpu32", "cpu", torch.float32), ("cpu16", "cpu", torch.bfloat16),
                              ("card16", dev, torch.bfloat16)):
            victim = create_model(name, input_size=size, device=d, state_dict=weights,
                                  dtype=dtype, **kwargs) if tag != "cpu32" or kwargs else cpu32
            xt = x.to(d).requires_grad_(True)
            logits = victim(xt)
            (grad,) = torch.autograd.grad(attack_loss(logits.float(), labels.to(d),
                                                      loss="logits"), xt)
            out[tag] = (logits.detach().float().cpu(), grad.cpu(), logits.dtype)
        torch.cuda.synchronize()
        label = name + (" s2d folded" if kwargs else "")
        ratios = [_rel(out["card16"][i], out["cpu16"][i]) / _rel(out["cpu16"][i], out["cpu32"][i])
                  for i in (0, 1)]
        argmax = bool((out["card16"][0].argmax(-1) == out["cpu16"][0].argmax(-1)).all())
        print(f"bf16 small-size {label} at {size}x{size}: card against CPU over the CPU's "
              f"bf16-vs-fp32 gap: logits {ratios[0]:.3f}, CW input gradient {ratios[1]:.3f} "
              f"(tol 1; the gap {_rel(out['cpu16'][0], out['cpu32'][0]):.2e} and "
              f"{_rel(out['cpu16'][1], out['cpu32'][1]):.3f}), argmax equal {argmax}")
        if out["card16"][2] != torch.bfloat16 or not argmax or not max(ratios) <= 1.0:
            raise AssertionError(f"bf16 {label} on the card leaves the gap rule: {ratios}")


def bf16_victim(dev, root: str, model: str = "resnet50", size: int = 224, n: int = 64,
                k: int = 100, steps: int = 30, batch: int = 128, n_steps: int = 10):
    """A bf16 victim (``create_model(dtype=torch.bfloat16)``) beside the fp32
    one on ``model``: 10 chained ``gd`` steps at b``n``, a supervised DDrague
    batch of ``n`` (``steps`` steps) and a supervised AdamW-codes batch
    through ``ADIL``, one ``cli.generate`` batch of ``batch`` (supervised,
    the classifier tempered), then ``bench.py``'s configuration (bf16, the
    S2D stem on blocked input, BatchNorms folded: the step and a DDrague
    batch through the twin). Each path prints its wall, launches and
    fooled share, the step and DDrague their busy share; every tensor
    handed to a kernel must be fp32. Returns the (fused_perturb,
    fused_adamw_project) launches of the timed runs."""
    import dataclasses
    import functools

    from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
    from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
    from dl_attack_on_imagenet_tpu_torch.cli import _victim, dataset, generate
    from dl_attack_on_imagenet_tpu_torch.models import blocked_twin, create_model, space_to_depth
    from dl_attack_on_imagenet_tpu_torch.ops import fused_adamw_project, fused_perturb
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    cfg = core.AdilConfig(eps=EPS, norm="linf", n_atoms=k, loss="logits", kappa=50.0,
                          step_size=0.01, batch_size=n)
    g = torch.Generator(device=dev).manual_seed(1)
    images = torch.rand((n, size, size, 3), generator=g, device=dev)
    start = core.init_state(g, (size, size, 3), n, cfg)
    dicts = os.path.join(root, "bf16_dicts")
    cache = ArtifactCache(dicts)
    _save_dictionary(dev, cache, model, size, k)
    walls, perturb, adamw = {}, 0, 0
    with _kernel_dtypes() as seen:
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            victim = create_model(model, input_size=size, device=dev, seed=0, dtype=dtype)
            labels = core.predict_labels(victim, images)
            state = _state_copy(start)
            ms, launches, losses = _timed_steps(victim, cfg, state, images, labels, n_steps)
            adamw += launches
            walls[tag, "step"] = ms / 1e3
            _check_trained(f"{tag} victim train", state.d, state.v, EPS)
            print(f"bf16 victim phase, {tag} {model}: gd step at b{n} K={k} {size}x{size} "
                  f"{ms:.2f} ms/step over {n_steps} chained steps, fused_adamw_project launches "
                  f"{launches}, loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f}")
            idx, mask = torch.arange(n, device=dev), torch.ones(n, device=dev)
            print_device_breakdown(f"{tag} victim train step", lambda: core.make_train_step(
                victim, cfg, "both")(state, images, labels, idx, mask), ms / 1e3)
            for mode in ("supervised", "supervised_adamw"):
                attack = ADIL(victim, eps=EPS, n_atoms=k, loss="logits", steps_inference=steps,
                              cache=cache)
                run = attack.forward_supervised_adamw if mode == "supervised_adamw" else attack
                full = attack.cfg
                attack.cfg = dataclasses.replace(full, steps_inference=2, steps_code=2)
                run(images)  # warm-up at 2 solver steps
                attack.cfg = full
                _zero_counts()
                adv, wall = _timed_run(lambda: run(images))
                launches = (fused_perturb.launches, fused_adamw_project.launches)
                perturb += launches[0]
                walls[tag, mode] = wall
                linf = float((adv - images).abs().max())
                print(f"bf16 victim phase, {tag} {mode}: wall {wall:.3f} s, launches "
                      f"{launches[0]} / {launches[1]}, fooled share "
                      f"{_fooled_share(victim, adv, images):.4f}, |adv - x|_inf {linf:.6f}")
                if launches != (1, 0) or adv.dtype != torch.float32 or not (
                        bool(torch.isfinite(adv).all()) and float(adv.min()) >= 0
                        and float(adv.max()) <= 1):
                    raise AssertionError(f"{tag} {mode}: launches {launches} or bad adversaries")
                if mode == "supervised_adamw" and not linf <= EPS + 1e-5:
                    raise AssertionError(f"{tag} {mode}: l∞ budget broken: {linf}")
                if mode == "supervised":
                    print_device_breakdown(f"{tag} victim DDrague", lambda: run(images), wall)

        # One cli.generate batch of `batch` in each dtype, the classifier
        # tempered as in the generate phase (CE saturates on the seed-0 net).
        blob_images = np.random.default_rng(5).random((batch, size, size, 3), dtype=np.float32)
        blob = os.path.join(root, "bf16_blob.npz")
        dataset.save_blob(blob, blob_images, np.zeros(batch), ["synthetic"])
        tempered = create_model(model, input_size=size, device=dev, seed=0)
        _temper(tempered, torch.as_tensor(blob_images, device=dev))
        weights = os.path.join(root, f"{model}_bf16_tempered.pt")
        torch.save({key: t.cpu() for key, t in tempered.net.state_dict().items()}, weights)
        real_build = _victim.build_victim
        for tag, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
            out = os.path.join(root, f"bf16_generate_{tag}")
            args = generate.build_argparser().parse_args([
                "--model", model, "--dict-dir", dicts, "--device", str(dev), "--input-size",
                str(size), "--steps-inference", str(steps), "--batch-size", str(batch),
                "--weights", weights, "--blob", blob, "--out-dir", out])
            _victim.build_victim = functools.partial(real_build, dtype=dtype)
            try:
                _zero_counts()
                summary, wall = _timed_run(lambda: generate.main(args))
            finally:
                _victim.build_victim = real_build
            (report,) = _read_report(out)
            perturb += fused_perturb.launches
            walls[tag, "generate"] = report["seconds"]
            print(f"bf16 victim phase, {tag} cli.generate: one supervised batch of {batch} "
                  f"{report['seconds']:.3f} s ({batch / report['seconds']:.2f} images/s; the "
                  f"call {wall:.2f} s with the victim's build), fooling rate "
                  f"{report['fooling']:.4f}, mse {report['mse']:.6f}, fused_perturb launches "
                  f"{fused_perturb.launches}")
            if fused_perturb.launches != 1 or summary["total"] != batch:
                raise AssertionError(f"{tag} generate: {fused_perturb.launches} launches")

        # bench.py's configuration: bf16, the S2D stem on blocked input,
        # BatchNorms folded; the gd step and DDrague through the twin.
        victim = create_model(model, input_size=size, device=dev, seed=0, dtype=torch.bfloat16,
                              stem_s2d=True, fold_bn=True)
        twin = blocked_twin(victim)
        state = _state_copy(start)
        state.d = space_to_depth(core.d_image(state.d, (size, size, 3))).reshape(k, -1)
        state.d_mu, state.d_nu = torch.zeros_like(state.d), torch.zeros_like(state.d)
        xs = space_to_depth(images)
        labels = core.predict_labels(twin, xs)
        ms, launches, losses = _timed_steps(twin, cfg, state, xs, labels, n_steps)
        adamw += launches
        walls["bench", "step"] = ms / 1e3
        print_device_breakdown("bench.py's configuration train step", lambda: core.make_train_step(
            twin, cfg, "both")(state, xs, labels, idx, mask), ms / 1e3)
        print(f"bf16 victim phase, bench.py's configuration (bf16, stem_s2d on blocked input, "
              f"fold_bn): gd step {ms:.2f} ms/step, fused_adamw_project launches {launches}, "
              f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f}")
        attack = ADIL(victim, eps=EPS, n_atoms=k, loss="logits", steps_inference=steps,
                      cache=cache, blocked=True)
        attack(images)  # warm-up, and the blocked dictionary's build
        _zero_counts()
        adv, wall = _timed_run(lambda: attack(images))
        perturb += fused_perturb.launches
        walls["bench", "supervised"] = wall
        print(f"bf16 victim phase, bench.py's configuration: DDrague through the twin {wall:.3f} "
              f"s, fused_perturb launches {fused_perturb.launches}, fooled share "
              f"{_fooled_share(victim, adv, images):.4f}")
        if fused_perturb.launches != 1 or not bool(torch.isfinite(adv).all()):
            raise AssertionError("bench configuration DDrague: launches or bad adversaries")
    kinds = sorted((name, str(dt)) for name, dt in seen)
    print(f"bf16 victim phase: tensors handed to the kernels: {kinds}")
    if {dt for _, dt in seen} != {torch.float32} or len({name for name, _ in seen}) != 2:
        raise AssertionError(f"a kernel got another dtype than fp32, or did not run: {kinds}")
    print("bf16 victim phase, bf16 over fp32: " + ", ".join(
        f"{what} {walls['bf16', what] / walls['fp32', what]:.3f}"
        for what in ("step", "supervised", "supervised_adamw", "generate"))
        + f"; bench.py's configuration over the fp32 step {walls['bench', 'step'] / walls['fp32', 'step']:.3f}")
    return perturb, adamw


ACTIVATION_MODES = tuple((pool, relu) for pool in ("sas", "vjp", "slices")
                         for relu in ("plain", "bool", "packed"))


def activation_modes(dev, model: str = "resnet50", size: int = 224, n: int = 64, k: int = 100,
                     n_steps: int = 5) -> int:
    """The ``gd`` step on ``model`` at b``n`` under each ``ADIL_MAXPOOL`` x
    ``ADIL_RELU`` mode (set through ``models.layers.POOL_MODE`` and
    ``RELU_MODE``, which the environment names set at import): ms a step
    over ``n_steps`` chained steps after a warm-up, the peak memory of those
    steps, and the CW input gradient's largest gap from the default modes'
    under deterministic cuDNN (0 expected but under ``slices``, which
    splits a tie, and ``vjp``, which adds overlapping windows' gradients in
    its own order). Returns the fused_adamw_project launches."""
    from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
    from dl_attack_on_imagenet_tpu_torch.models import create_model, layers
    from dl_attack_on_imagenet_tpu_torch.ops import attack_loss

    victim = create_model(model, input_size=size, device=dev, seed=0)
    cfg = core.AdilConfig(eps=EPS, n_atoms=k, loss="logits", batch_size=n)
    g = torch.Generator(device=dev).manual_seed(2)
    images = torch.rand((n, size, size, 3), generator=g, device=dev)
    start = core.init_state(g, (size, size, 3), n, cfg)
    labels = core.predict_labels(victim, images)
    base, total, gaps = None, 0, {}
    modes = (layers.POOL_MODE, layers.RELU_MODE)
    try:
        for pool, relu in ACTIVATION_MODES:
            layers.POOL_MODE, layers.RELU_MODE = pool, relu
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ms, launches, _ = _timed_steps(victim, cfg, _state_copy(start), images, labels,
                                           n_steps)
            peak = torch.cuda.max_memory_allocated(dev)
            total += launches
            x = images.clone().requires_grad_(True)
            with _deterministic_cudnn():
                (grad,) = torch.autograd.grad(attack_loss(victim(x), labels, loss="logits"), x)
            base = grad if base is None else base
            gap = float((grad - base).abs().max())
            print(f"activation modes, ADIL_MAXPOOL={pool} ADIL_RELU={relu}: gd step on {model} "
                  f"at b{n} {ms:.2f} ms/step over {n_steps} chained steps, peak memory "
                  f"{peak / 2**30:.3f} GiB, fused_adamw_project launches {launches}, input "
                  f"gradient's largest gap from the default {gap:.3e} (|gradient| up to "
                  f"{float(base.abs().max()):.3e})")
            if pool == "sas" and gap != 0.0:
                raise AssertionError(f"ADIL_RELU={relu} changed the input gradient: {gap}")
            if relu != "plain" and gap != gaps[pool]:
                raise AssertionError(f"ADIL_RELU={relu} under ADIL_MAXPOOL={pool} changed the "
                                     f"input gradient: {gap} against {gaps[pool]}")
            gaps.setdefault(pool, gap)
    finally:
        layers.POOL_MODE, layers.RELU_MODE = modes
    return total


def main() -> None:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    global CARD
    CARD = smi
    dev = torch.device("cuda", 0)
    _set_precision()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn allow_tf32={torch.backends.cudnn.allow_tf32}, matmul "
          "allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    from dl_attack_on_imagenet_tpu_torch.ops import native

    t0 = time.perf_counter()
    for name, out in native.build(native.SOURCES, ptxas_info=True).items():
        print(f"built {name} ({time.perf_counter() - t0:.1f} s)\n{out.strip()}")

    walls = {"builds": time.perf_counter() - t0}

    def timed(name, phase, *args, **kwargs):
        t0 = time.perf_counter()
        out = phase(*args, **kwargs)
        walls[name] = time.perf_counter() - t0
        return out

    kernels = [timed("fused_perturb check", check_fused_perturb, dev),
               timed("fused_adamw_project check", check_fused_adamw_project, dev)]
    timed("small-size checks", lambda: (check_small_against_cpu(dev),
                                        check_train_small_against_cpu(dev),
                                        check_families_against_cpu(dev)))
    kernels[0]["launches"] = timed("serve", serve, dev)
    kernels[1]["launches"] = (timed("train", train, dev)
                              + timed("learn_dictionary", learn_entry_points, dev))
    zoo_launches, zoo_err = timed("zoo", serve_zoo, dev)
    kernels[0]["launches"] += zoo_launches
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], zoo_err)
    with tempfile.TemporaryDirectory() as root:
        for name, phase in (("demo experiment", demo_experiment),
                            ("single image", single_image_attack)):
            perturb, adamw = timed(name, phase, dev, root)
            kernels[0]["launches"] += perturb
            kernels[1]["launches"] += adamw
    perturb, adamw = timed("mixed precision", mixed_precision, dev)
    kernels[0]["launches"] += perturb
    kernels[1]["launches"] += adamw
    kernels[1]["launches"] += timed("dp world size 1", dp_world_one, dev)
    kernels[1]["launches"] += timed("dp 2 ranks", dp_two_ranks, dev)
    kernels[1]["launches"] += timed("dp sharded checkpoint", dp_sharded, dev)
    with tempfile.TemporaryDirectory() as root:
        perturb, adamw = timed("demo experiment distributed mixed", demo_experiment, dev, root,
                               extra=("--distributed", "--mixed-precision"))
        kernels[0]["launches"] += perturb
        kernels[1]["launches"] += adamw
    timed("universal baselines", universal_baselines, dev)
    timed("torchattacks grid", torchattacks_grid, dev)
    perturb, adamw, (perturb_row, adamw_row) = timed("adilr", adilr, dev)
    kernels[0]["launches"] += perturb
    kernels[1]["launches"] += adamw
    kernels[0]["adilr"], kernels[1]["adilr"] = perturb_row, adamw_row
    for row, extra in zip(kernels, (perturb_row, adamw_row)):
        row["max_abs_err"] = max(row["max_abs_err"], extra["max_abs_err"])
    perturb_rows, adamw_row = timed("kernels at the new shapes", check_kernels_at_new_shapes, dev)
    kernels[0].update(perturb_rows)
    kernels[1].update(adamw_row)
    for row, extra in ((kernels[0], perturb_rows["n128"]), (kernels[0], perturb_rows["blocked"]),
                       (kernels[1], adamw_row["blocked"])):
        row["max_abs_err"] = max(row["max_abs_err"], extra["max_abs_err"])
    with tempfile.TemporaryDirectory() as root:
        perturb, blob, dicts, weights = timed("generate", generate_phase, dev, root)
        kernels[0]["launches"] += perturb
        kernels[0]["launches"] += timed("import", import_phase, dev, root)
        timed("s2d stems", check_s2d_stems, dev)
        perturb, adamw = timed("blocked", blocked_phase, dev)
        kernels[0]["launches"] += perturb
        kernels[1]["launches"] += adamw
        timed("trace", trace_phase, dev, root, blob, dicts, weights)
        perturb, adamw = timed("bf16 victim", bf16_victim, dev, root)
        kernels[0]["launches"] += perturb
        kernels[1]["launches"] += adamw
    timed("bf16 small-size checks", check_bf16_families_against_cpu, dev)
    kernels[1]["launches"] += timed("activation modes", activation_modes, dev)
    from dl_attack_on_imagenet_tpu_torch.parallel.dist import shutdown

    shutdown()
    print("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5]))
    else:
        main()
