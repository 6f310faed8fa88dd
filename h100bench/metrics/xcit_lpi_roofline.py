"""xcit_lpi_roofline: the least time for the window's XCiT LPI sublayers
over the card's seconds in the ``victim/xcit/lpi`` spans, forward plus
input-gradient backward (percent), by the program's CUDA event pairs: the
spans, not kernel names, so that any implementation of the work is read
by the same yardstick.

The least time is counted from the configuration, whatever implements the
work: per image a sublayer x -> x + γ3 LPI(LN3 x) holds N·C elements (the
tokens times the width), and over XCiT-L12's 12 blocks ΣNC is 196 · 768 ·
12 = 1,806,336. A forward reads the stream and writes it, 8 B an element,
against 4·k² flop (two k x k depthwise convolutions, 36 at k = 3); an
input-gradient backward reads the output's gradient and the stream and
writes the stream's gradient, 12 B an element, against the same flop.
Each direction takes the larger of its bytes at the HBM rate and its flop
at the fp32 rate: both are bound by bytes (0.276 ms forward and 0.414 ms
backward a pass at batch 64). Passes are the window's victim passes, a
backward where the pass records an input gradient. None off the card, and
where the span did not open (a program or a victim without it)."""

from __future__ import annotations

from dl_attack_on_imagenet_tpu_torch.utils import profiling
from h100bench import arith

SPAN = "victim/xcit/lpi"
FORWARD_BYTES, BACKWARD_BYTES = 8, 12  # an element, fp32


def elements(config) -> int:
    """ΣNC: tokens times width over every block, an image."""
    side = config["input_size"] // config["patch_size"]
    return side * side * config["embed_dim"] * config["depth"]


def direction_seconds(n: int, flop_per: int, bytes_per: int) -> float:
    """The least time of one direction over ``n`` elements."""
    return max(arith.least_seconds(bytes_per * n),
               flop_per * n / arith.peak_flop_per_s("float32"))


def pass_seconds(n: int, flop_per: int, grad: bool) -> float:
    """The least time of a forward over ``n`` elements and, where ``grad``,
    of its input gradient's backward."""
    forward = direction_seconds(n, flop_per, FORWARD_BYTES)
    return forward + (direction_seconds(n, flop_per, BACKWARD_BYTES) if grad else 0.0)


def least_seconds(config, passes) -> float:
    n, flop_per = elements(config), 4 * config["lpi_kernel_size"] ** 2
    return sum(batch * pass_seconds(n, flop_per, grad) for batch, grad in passes)


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
