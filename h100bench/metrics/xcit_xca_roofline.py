"""xcit_xca_roofline: the least time for the window's XCiT XCA cores over
the device time of the kernels that perform them, ``xcit_xca_*`` (percent).

The core is each block's work from the qkv GEMM's output to the proj
GEMM's input: the l2 norms of q and k over the tokens, the d x d scores
with the temperature, their softmax, and its product with v. The least
time is counted from the configuration, whatever implements it: per image
a block holds N·C token-channels (the tokens times the width), and over
XCiT-L12's 12 blocks ΣNC is 196 · 768 · 12 = 1,806,336. A forward reads q,
k and v and writes the output, 16 B·ΣNC (28.9 MB an image), against
4·d·ΣNC flop (d = embed_dim / num_heads = 48: the Gram and the product
with v, 2d each); an input-gradient backward reads q, k, v and the
output's gradient and writes dq, dk and dv, 28 B·ΣNC (50.6 MB), against
8·d·ΣNC flop. Each direction takes the larger of its bytes at the HBM
rate and its flop at the fp32 rate: both are bound by bytes (0.552 ms
forward and 0.966 ms backward a pass at batch 64). Passes are the
window's victim passes, a backward where the pass records an input
gradient. None where no such kernel ran (a program without it)."""

from h100bench import arith
from h100bench.readers import kernel_seconds

KERNELS = ("xcit_xca",)
FORWARD_BYTES, BACKWARD_BYTES = 16, 28  # a token-channel, fp32
FORWARD_FLOP, BACKWARD_FLOP = 4, 8  # a token-channel and channel of its head


def token_channels(config) -> int:
    """ΣNC: tokens times width over every block, an image."""
    side = config["input_size"] // config["patch_size"]
    return side * side * config["embed_dim"] * config["depth"]


def head_dim(config) -> int:
    return config["embed_dim"] // config["num_heads"]


def direction_seconds(nc: int, d: int, bytes_per: int, flop_per: int) -> float:
    """The least time of one direction over ``nc`` token-channels."""
    return max(arith.least_seconds(bytes_per * nc),
               flop_per * d * nc / arith.peak_flop_per_s("float32"))


def pass_seconds(nc: int, d: int, grad: bool) -> float:
    """The least time of a forward over ``nc`` token-channels and, where
    ``grad``, of its input gradient's backward."""
    forward = direction_seconds(nc, d, FORWARD_BYTES, FORWARD_FLOP)
    return forward + (direction_seconds(nc, d, BACKWARD_BYTES, BACKWARD_FLOP) if grad else 0.0)


def least_seconds(config, passes) -> float:
    nc, d = token_channels(config), head_dim(config)
    return sum(batch * pass_seconds(nc, d, grad) for batch, grad in passes)


def read(ctx):
    if not ctx.on_device or not ctx.passes:
        return None
    seconds = kernel_seconds(ctx, KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * least_seconds(ctx.config, ctx.passes) / seconds
