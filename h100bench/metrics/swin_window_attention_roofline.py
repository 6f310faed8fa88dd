"""swin_window_attention_roofline: the least time for the window's Swin
window attentions over the device time of the kernels that perform them,
``swin_window_attention_*`` (percent). The least time is counted from the
configuration, whatever implements the attention: per image a block holds
T·C token-channels (its map's tokens times its width), and over Swin-B's 24
blocks ΣTC is 3,110,912. A forward reads q, k and v and writes the output,
16 B·ΣTC (49.8 MB an image), against 4·w²·ΣTC flop (w² = 49 tokens a
window); an input-gradient backward reads q, k, v and the output's
gradient and writes dq, dk and dv, 28 B·ΣTC (87.1 MB), against 8·w²·ΣTC
flop (recomputation not counted). Each direction takes the larger of its
bytes at the HBM rate and its flop at the fp32 rate: both are bound by
bytes. Passes are the window's victim passes, a backward where the pass
records an input gradient. None where no such kernel ran (a program
without it)."""

from h100bench import arith
from h100bench.readers import kernel_seconds

KERNELS = ("swin_window_attention",)
FORWARD_BYTES, BACKWARD_BYTES = 16, 28  # a token-channel, fp32
FORWARD_FLOP, BACKWARD_FLOP = 4, 8  # a token-channel and key


def token_channels(config) -> int:
    """ΣTC: tokens times channels of every block's map, an image."""
    side = config["input_size"] // config["patch_size"]
    return sum(depth * (side >> i) ** 2 * config["embed_dim"] * 2 ** i
               for i, depth in enumerate(config["depths"]))


def direction_seconds(tc: int, keys: int, bytes_per: int, flop_per: int) -> float:
    """The least time of one direction over ``tc`` token-channels."""
    return max(arith.least_seconds(bytes_per * tc),
               flop_per * keys * tc / arith.peak_flop_per_s("float32"))


def pass_seconds(tc: int, keys: int, grad: bool) -> float:
    """The least time of a forward over ``tc`` token-channels and, where
    ``grad``, of its input gradient's backward."""
    forward = direction_seconds(tc, keys, FORWARD_BYTES, FORWARD_FLOP)
    return forward + (direction_seconds(tc, keys, BACKWARD_BYTES, BACKWARD_FLOP) if grad else 0.0)


def least_seconds(config, passes) -> float:
    tc, keys = token_channels(config), config["window_size"] ** 2
    return sum(batch * pass_seconds(tc, keys, grad) for batch, grad in passes)


def read(ctx):
    if not ctx.on_device or not ctx.passes:
        return None
    seconds = kernel_seconds(ctx, KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * least_seconds(ctx.config, ctx.passes) / seconds
