"""xcit_lpi_share.attack: percent of the traced attack window's busy time
that the card spends in XCiT's ``victim/xcit/lpi`` spans (each block's
x + γ3 LPI(LN3 x): the norm, the tokens' copy to a map, the two 3x3
depthwise convolutions with GELU and BatchNorm between them, and the
residual add), forward and input-gradient backward, by the program's CUDA
event pairs."""

from h100bench.span_share import share


def read(ctx):
    return share(ctx, "victim/xcit/lpi")
