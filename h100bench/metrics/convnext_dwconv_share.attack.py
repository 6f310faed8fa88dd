"""convnext_dwconv_share.attack: percent of the traced attack window's busy
time that the card spends in ConvNeXt's ``victim/convnext/dwconv`` spans
(each block's 7x7 depthwise convolution z -> h, and its input gradient
from h's gradient to z's, the sum with the residual's gradient included),
forward and input-gradient backward, by the program's CUDA event pairs."""

from h100bench.span_share import share


def read(ctx):
    return share(ctx, "victim/convnext/dwconv")
