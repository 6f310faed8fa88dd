"""xcit_xca_share.attack: percent of the traced attack window's busy time
that the card spends in XCiT's ``victim/xcit/xca`` spans (each block's
x + γ1 XCA(LN1 x): the norm, the qkv GEMM, the l2 norms over the tokens,
the d x d products, the softmax with its temperature, the values, the
projection and the residual add), forward and input-gradient backward, by
the program's CUDA event pairs."""

from h100bench.span_share import share


def read(ctx):
    return share(ctx, "victim/xcit/xca")
