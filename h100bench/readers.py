"""What the per-layer metrics' readers (``metrics/<name>.py``) share.

A reader takes the run's context: ``config``, ``mix``, ``units`` (whole
units in the window), ``passes`` (the victim's passes in the window, as
(batch, whether it records for an input gradient)), ``host_s`` (the
job's host-clock readings by name), ``on_device`` and,
from the profiler on the card, ``trace`` (``window_s``, ``busy_s``,
``kernel_s`` by kernel name). It returns a number, or None where it finds
nothing to read; a share of a roofline or a peak is never made up as 0.
"""

from __future__ import annotations

import math

from . import arith


def kernel_seconds(ctx, names) -> float:
    """Device seconds in the window of the kernels whose names hold one of
    ``names``."""
    return sum(s for k, s in ctx.trace.kernel_s.items() if any(n in k for n in names))


def roofline(ctx, bytes_needed: float, names) -> float:
    """Percent: the least time for ``bytes_needed`` over the kernels' time."""
    if not ctx.on_device:
        return None
    seconds = kernel_seconds(ctx, names)
    if seconds <= 0 or bytes_needed <= 0:
        return None
    return 100.0 * arith.least_seconds(bytes_needed) / seconds


def mfu(ctx) -> float:
    """Percent of the configuration's peak: the victim's model FLOPs in the
    window (its forward for every image of a pass, and its input-gradient
    backward where the pass records one; the counts per image are the
    configuration's ``flops_per_image``) over the traced window."""
    if not ctx.on_device or not ctx.passes:
        return None
    per = ctx.config["flops_per_image"]
    flops = sum(b * (per["forward"] + (per["input_grad_backward"] if grad else 0))
                for b, grad in ctx.passes)
    peak = arith.peak_flop_per_s(ctx.config["precision"]["dtype"])
    return 100.0 * flops / (ctx.trace.window_s * peak)


def idle(ctx) -> float:
    if not ctx.on_device:
        return None
    return arith.idle_share(ctx.trace.busy_s, ctx.trace.window_s)


def train_steps(ctx) -> int:
    """Steps of the window's epochs: a unit is one epoch of the job."""
    return ctx.units * math.ceil(ctx.mix["images"] / ctx.mix["batch"])


def image_size(config) -> int:
    return config["input_size"] * config["input_size"] * 3
