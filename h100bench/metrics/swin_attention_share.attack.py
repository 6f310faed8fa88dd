"""swin_attention_share.attack: percent of the traced attack window's busy
time that the card spends in Swin's ``victim/swin/attention`` spans (each
block's x + attention(norm1(x)): the norm, the shift and partition, the
q/k/v projection, the windowed scores with their bias and mask, softmax,
the values, the projection, the reverse shift and the residual add),
forward and input-gradient backward, by the program's CUDA event pairs."""

from h100bench.span_share import share


def read(ctx):
    return share(ctx, "victim/swin/attention")
