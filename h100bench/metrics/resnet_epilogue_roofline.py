"""resnet_epilogue_roofline: the least time for the window's
post-convolution work of a ResNet victim (each frozen BatchNorm, the
residual add where a block ends, each ReLU) over the device time of the
kernels that perform it, ``resnet_epilogue_*`` (percent). Read as
``resnet_epilogue_roofline.learn`` and ``resnet_epilogue_roofline.attack``,
one for each end-to-end metric it moves.

The least time is counted from the configuration (``stage_sizes``,
``width``, ``expansion``, ``input_size``), whatever implements the work. A
forward reads the convolution's output and writes the activation at each
ReLU site: 8 B an element where a convolution, its BatchNorm and a ReLU
follow one another (the stem, and every convolution of a block but its
last), 12 B at each block output, where the residual is read too. An
input-gradient backward reads the output's gradient and the saved output
and writes the masked, scaled gradient: 12 B an element at every ReLU site.
All of it at the HBM rate; passes are the window's victim passes, a
backward where the pass records an input gradient. For ResNet-50 at 224²
that is 98,947,072 B forward and 115,304,448 B backward an image. None
where no such kernel ran (a program without it)."""

from h100bench import arith
from h100bench.readers import kernel_seconds

KERNELS = ("resnet_epilogue",)
INNER_BYTES, OUTPUT_BYTES, BACKWARD_BYTES = 8, 12, 12  # an element, fp32


def _down(side: int) -> int:
    """A map's side after a stride-2 convolution or pool of this family."""
    return (side + 1) // 2


def site_elements(config):
    """(elements at conv -> BatchNorm -> ReLU sites, elements at block
    outputs), an image."""
    width, expansion = config["width"], config["expansion"]
    side = _down(config["input_size"])  # the stem's 7x7/2 convolution
    inner = width * side * side
    side = _down(side)  # its 3x3/2 max pool
    outputs = 0
    for stage, blocks in enumerate(config["stage_sizes"]):
        planes = width * 2 ** stage
        for block in range(blocks):
            out_side = _down(side) if stage > 0 and block == 0 else side
            if expansion == 1:  # BasicBlock: the stride on its first convolution
                inner += planes * out_side * out_side
            else:  # Bottleneck: a 1x1 at the input's side, the stride on the 3x3
                inner += planes * (side * side + out_side * out_side)
            outputs += planes * expansion * out_side * out_side
            side = out_side
    return inner, outputs


def image_bytes(config):
    """(forward bytes, input-gradient backward bytes) an image."""
    inner, outputs = site_elements(config)
    return INNER_BYTES * inner + OUTPUT_BYTES * outputs, BACKWARD_BYTES * (inner + outputs)


def pass_seconds(config, batch: int, grad: bool) -> float:
    """The least time of a forward of ``batch`` images and, where ``grad``,
    of its input gradient's backward."""
    forward, backward = image_bytes(config)
    return arith.least_seconds(batch * (forward + (backward if grad else 0)))


def read(ctx):
    if not ctx.on_device or not ctx.passes:
        return None
    seconds = kernel_seconds(ctx, KERNELS)
    if seconds <= 0:
        return None
    least = sum(pass_seconds(ctx.config, batch, grad) for batch, grad in ctx.passes)
    return 100.0 * least / seconds
