"""One run of one cell: set-up, the measured window, the check, the line.

``run.py`` calls :func:`main`. A cell is an entry of ``workloads`` in
``BENCHMARK.json``: a configuration (``configs/<config>.json``), a traffic
mix (``mixes/<traffic>.json``, whose ``job`` names the job module in
``jobs/``) and the limits its check is held to (``limits/<workload>.json``).
Each per-layer metric is read by ``metrics/<name>.py``. Nothing here needs
an edit for a new cell or metric.

A job module has ``setup(run)``, ``unit(state, i)`` (one unit of work:
an epoch of a learning job, an attacked batch), ``work(state)`` (its
end-to-end metrics' work counts, by metric name) and ``check(state,
wanted)`` (frees the program's state, runs the plain reference and
returns the numbers ``wanted``, by name). A state may carry ``host_s``,
host-clock readings by name, for the per-layer readers.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import arith

BENCH_DIR = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "dl_attack_on_imagenet_tpu")
SPAN = "bench/"


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str) -> SimpleNamespace:
    """The cell's entry, configuration, mix and limits, found by name."""
    spec = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    bench = root / BENCH_DIR.name
    limits_path = bench / "limits" / f"{workload}.json"
    return SimpleNamespace(
        spec=spec, cell=cell, bench=bench,
        config=read_json(bench / "configs" / f"{cell['config']}.json"),
        mix=read_json(bench / "mixes" / f"{cell['traffic']}.json"),
        limits=read_json(limits_path) if limits_path.exists() else None)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@contextlib.contextmanager
def lower_precision():
    """TF32 in cuDNN and cuBLAS: the step below fp32, for the control."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def set_precision(precision: dict) -> None:
    """The configuration's precision on the card: TF32 on or off for cuDNN
    and for cuBLAS, and fp32 accumulation for bf16 products."""
    torch.backends.cudnn.allow_tf32 = bool(precision["cudnn_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(precision["matmul_tf32"])
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class Tape:
    """Records a victim's passes once armed: each input, its logits and,
    after the backward, the input's gradient. ``only_grad`` keeps the
    passes that record for an input gradient; ``limit`` caps the passes
    kept; ``host`` keeps them in pinned host memory, copied as the card
    goes (valid after a synchronisation), so that they add nothing to the
    card's peak. Hook a module (``Tape(module)``) or wrap a callable
    (``tape.wrap(fn)``)."""

    def __init__(self, module=None, limit: int = 1 << 30, only_grad: bool = False,
                 host: bool = False):
        self.records, self.limit, self.only_grad, self.host = [], limit, only_grad, host
        self._handle = module.register_forward_hook(self._hook) if module is not None else None

    def _hook(self, module, args, output):
        self.record(args[0], output)

    def _keep(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if not self.host:
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        return out.copy_(t, non_blocking=True)

    def record(self, x, logits):
        grad = x.requires_grad and torch.is_grad_enabled()
        if len(self.records) >= self.limit or (self.only_grad and not grad):
            return
        rec = {"x": self._keep(x), "logits": self._keep(logits.float()), "grad": None}
        if grad:
            x.register_hook(lambda g: rec.__setitem__("grad", self._keep(g)))
        self.records.append(rec)

    def wrap(self, fn):
        def recorded(x):
            out = fn(x)
            self.record(x, out)
            return out
        return recorded

    def close(self) -> None:
        if self._handle is not None:
            self._handle.remove()


def on_device(records: list, device) -> list:
    """Tape records moved to ``device``."""
    return [{k: (v.to(device) if v is not None else None) for k, v in rec.items()}
            for rec in records]


class PassCounter:
    """A forward hook on the victim's network: the batch size of every
    pass and whether it records a graph for an input gradient."""

    def __init__(self, net: torch.nn.Module):
        self.passes = []
        self._handle = net.register_forward_hook(self._hook)

    def _hook(self, module, args, output):
        x = args[0]
        self.passes.append((int(x.shape[0]), bool(torch.is_grad_enabled() and x.requires_grad)))

    def close(self) -> None:
        self._handle.remove()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(unit, seconds: float, device, trace: bool):
    """Whole units until ``seconds`` have passed; the window closes at the
    end of the unit in progress. Returns (units, seconds, profiler)."""
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=activities) if trace else contextlib.nullcontext()
    with prof:
        with record_function(SPAN + "window"):
            sync(device)
            start = time.perf_counter()
            n = 0
            while True:
                unit(n)
                sync(device)
                n += 1
                if time.perf_counter() - start >= seconds:
                    break
            elapsed = time.perf_counter() - start
    return n, elapsed, prof if trace else None


def _kind(e) -> str:
    """"span" for a CPU ``record_function`` range, "device" for a kernel,
    copy or memset on the card, "" for the rest: user annotations also
    appear on the card's timeline, mirroring the host's ranges, and are no
    device work, nor are the host's synchronisation events."""
    on_cpu = e.device_type() == torch.autograd.DeviceType.CPU
    if e.is_user_annotation():
        return "span" if on_cpu else ""
    return "" if on_cpu or "Sync" in e.name() else "device"


def read_trace(prof, top: int = 10) -> SimpleNamespace:
    """The traced window: its length, the union of the device's kernel,
    copy and memset intervals in it, device time by kernel name, the
    longest device operations and the longest idle gaps, each gap named by
    the innermost benchmark span open at its start."""
    spans, device = [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind == "span" and e.name().startswith(SPAN):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif kind == "device":
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    lo, hi = next((s, e) for s, e, name in spans if name == SPAN + "window")
    by_name: dict = {}
    for s, e, name in device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_name[name] = by_name.get(name, 0) + (e - s)
    intervals = [(s, e) for s, e, _ in device]
    gaps = sorted(arith.gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:top]

    def span_at(t):
        open_ = [(s, name) for s, e, name in spans if s <= t < e]
        return max(open_)[1] if open_ else SPAN + "window"

    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return SimpleNamespace(
        window_s=(hi - lo) / 1e9,
        busy_s=arith.busy(intervals, lo, hi) / 1e9,
        kernel_s={name: ns / 1e9 for name, ns in by_name.items()},
        device_ops=[[name[:200], ns / 1e9] for name, ns in ops],
        idle_gaps=[[span_at(s), (e - s) / 1e9] for s, e in gaps])


def load_metric(bench: Path, name: str):
    """The reader ``metrics/<name>.py`` of a per-layer metric."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def judge(readings: dict, limits) -> tuple:
    """(correct, the numbers compared beside their limits). Every number
    that ``limits`` names has to be finite and at or under its limit; one
    missing or not finite is shown as null and fails."""
    if not limits:
        return False, {}
    checks, ok = {}, True
    for name, limit in limits["limits"].items():
        value = readings.get(name)
        if value is None or not math.isfinite(value):
            value, ok = None, False
        else:
            ok = ok and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, started: float, workdir: str) -> dict:
    """One run of ``workload``; returns the result line as a dict."""
    ready = time.perf_counter()
    found = load_cell(root, workload)
    set_precision(found.config["precision"])
    job = importlib.import_module(f"h100bench.jobs.{found.mix['job']}")
    wanted = list(found.limits["limits"]) if found.limits else []
    run = SimpleNamespace(config=found.config, mix=found.mix, seed=seed, device=device,
                          workdir=workdir, wanted=wanted)
    with record_function(SPAN + "setup"):
        state = job.setup(run)
    sync(device)
    print(f"h100bench: set-up {time.perf_counter() - started:.3f} s, of which "
          f"{time.perf_counter() - ready:.3f} s after the imports (weights, inputs, the "
          f"program, the warm-up unit)", file=sys.stderr)
    counter = PassCounter(state.net)
    setup_s = time.perf_counter() - started
    units, window_s, prof = measure(lambda i: job.unit(state, i), seconds, device, trace)
    counter.close()
    info = device_info(device)
    work = job.work(state)
    readings = job.check(state, wanted)
    correct, checks = judge(readings, found.limits)

    metrics = {}
    if not trace:
        values = {name: arith.rate(w, window_s) for name, w in work.items()}
        values["setup_s"] = setup_s
        values["peak_mem_gib"] = info["memory_peak_bytes"] / 2 ** 30 if device.type == "cuda" else None
        for m in found.spec["end_to_end"]:
            if applies(m, workload) and values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {"correct": correct, "attempted": units, "failed": 0, "metrics": metrics,
              "device": info}
    if trace:
        on_device = device.type == "cuda"
        seen = read_trace(prof) if on_device else None
        ctx = SimpleNamespace(config=found.config, mix=found.mix, units=units,
                              passes=counter.passes, on_device=on_device, trace=seen,
                              host_s=getattr(state, "host_s", {}),
                              window_s=seen.window_s if on_device else window_s)
        for m in found.spec["per_layer"]:
            if applies(m, workload):
                value = load_metric(found.bench, m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if on_device:
            info["busy_s"] = seen.busy_s
            info["window_s"] = seen.window_s
            result["breakdown"] = {"device_ops": seen.device_ops, "idle_gaps": seen.idle_gaps}
    result["checks"] = checks
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def workdir_root(root: Path) -> str:
    """Where a run writes its artifacts: under TMPDIR where it is set, else
    in the checkout."""
    base = os.environ.get("TMPDIR") or str(root / ".h100bench_work")
    os.makedirs(base, exist_ok=True)
    return base


def main(started: float, argv=None) -> int:
    args = parse(argv)
    root = BENCH_DIR.parent
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("h100bench: no CUDA device; a run measures the card and reports nothing "
              "without one", file=sys.stderr)
        return 3
    chips = load_cell(root, args.workload).cell["chips"]
    if torch.cuda.device_count() < chips:
        print(f"h100bench: the cell needs {chips} cards, {torch.cuda.device_count()} seen",
              file=sys.stderr)
        return 3
    workdir = tempfile.mkdtemp(prefix="h100bench-", dir=workdir_root(root))
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), started, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = banned_modules()
    if found:
        print(f"h100bench: the run loaded {', '.join(found)}; the benchmark measures the "
              f"PyTorch port alone", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
