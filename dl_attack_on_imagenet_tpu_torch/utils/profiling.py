"""Tracing and step timing.

Port of ``dl_attack_on_imagenet_tpu/utils/profiling.py``: ``trace(log_dir)``
records a torch.profiler trace of the host and the card into ``log_dir``,
``annotate(name)`` names a span in such a trace (a no-op without a
profiler), and ``StepTimer`` keeps wall-clock step statistics with the first ``warmup``
steps left out. A timed step must end in ``torch.cuda.synchronize()`` (or a
host read of its result), or the timer measures only the enqueue.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Record a torch.profiler trace of CPU and, where there is one, CUDA
    activity into ``log_dir`` as a Chrome trace (``trace.json``, which
    Perfetto and TensorBoard open); a no-op for None. ``annotate`` spans
    inside show in it."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named span visible in torch.profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step statistics with warm-up exclusion.

    Usage::

        timer = StepTimer(warmup=1)
        for batch in data:
            with timer.step():
                loss = train_step(...)
                float(loss)
        print(timer.summary())
    """

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: List[float] = []
        self._count = 0

    @contextlib.contextmanager
    def step(self):
        start = time.perf_counter()
        yield
        self.record(time.perf_counter() - start)

    def record(self, elapsed: float) -> None:
        """Record an externally measured step duration (same warm-up rule)."""
        self._count += 1
        if self._count > self.warmup:
            self.times.append(elapsed)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0, "mean_s": float("nan"),
                    "steps_per_sec": float("nan")}
        return {
            "steps": len(self.times),
            "mean_s": self.mean,
            "min_s": min(self.times),
            "max_s": max(self.times),
            "steps_per_sec": 1.0 / self.mean,
        }
