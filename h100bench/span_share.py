"""What the readers of a device-timed span's share (``metrics/swin_*``)
share: the window's device seconds under one program span, forward plus
backward (``utils.profiling.device_totals``), over the window's busy
seconds. None off the card, and where the program times no such span (a
program without the device clock, or a victim without the span)."""

from __future__ import annotations

from dl_attack_on_imagenet_tpu_torch.utils import profiling


def share(ctx, name: str):
    """Percent of the traced window's busy time spent in the span ``name``."""
    if not ctx.on_device or not hasattr(profiling, "device_totals"):
        return None
    total = profiling.device_totals().get(name)
    if total is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (total.forward_s + total.backward_s) / ctx.trace.busy_s
