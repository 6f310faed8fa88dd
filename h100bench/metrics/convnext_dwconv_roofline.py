"""convnext_dwconv_roofline: the least time for the window's ConvNeXt
depthwise convolutions over the card's seconds in the
``victim/convnext/dwconv`` spans, forward plus input-gradient backward
(percent), by the program's CUDA event pairs: the spans, not kernel names,
so that any implementation of the work is read by the same yardstick.

The least time is counted from the configuration, whatever implements the
work: per image a block holds C·H·W elements (its width times its map),
and over ConvNeXt-B's 36 blocks ΣCHW is 4,666,368. A forward reads z and
writes h, 8 B an element, against 2·k² flop (98 at k = 7); an input-
gradient backward reads h's gradient and the residual's and writes z's,
12 B an element, against the same flop. Each direction takes the larger of
its bytes at the HBM rate and its flop at the fp32 rate: both are bound by
bytes (0.713 ms forward and 1.070 ms backward a pass at batch 64). Passes
are the window's victim passes, a backward where the pass records an input
gradient. None off the card, and where the span did not open (a program
or a victim without it)."""

from __future__ import annotations

from dl_attack_on_imagenet_tpu_torch.utils import profiling
from h100bench import arith

SPAN = "victim/convnext/dwconv"
FORWARD_BYTES, BACKWARD_BYTES = 8, 12  # an element, fp32


def elements(config) -> int:
    """ΣCHW: channels times pixels of every block's map, an image."""
    side = config["input_size"] // 4  # the stem's stride
    return sum(depth * dim * (side >> i) ** 2
               for i, (dim, depth) in enumerate(zip(config["dims"], config["depths"])))


def direction_seconds(n: int, taps: int, bytes_per: int) -> float:
    """The least time of one direction over ``n`` elements."""
    return max(arith.least_seconds(bytes_per * n),
               2 * taps * n / arith.peak_flop_per_s("float32"))


def pass_seconds(n: int, taps: int, grad: bool) -> float:
    """The least time of a forward over ``n`` elements and, where ``grad``,
    of its input gradient's backward."""
    forward = direction_seconds(n, taps, FORWARD_BYTES)
    return forward + (direction_seconds(n, taps, BACKWARD_BYTES) if grad else 0.0)


def least_seconds(config, passes) -> float:
    n, taps = elements(config), config["kernel_size"] ** 2
    return sum(batch * pass_seconds(n, taps, grad) for batch, grad in passes)


def read(ctx):
    if not ctx.on_device or not ctx.passes or not hasattr(profiling, "device_totals"):
        return None
    total = profiling.device_totals().get(SPAN)
    if total is None:
        return None
    seconds = total.forward_s + total.backward_s
    if seconds <= 0:
        return None
    return 100.0 * least_seconds(ctx.config, ctx.passes) / seconds
