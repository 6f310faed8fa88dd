"""swin_shift_share.attack: percent of the traced attack window's busy
time that the card spends in Swin's ``victim/swin/shift`` spans (each
block's cyclic roll and window partition, and the reverse partition and
roll back; inside the attention's share), forward and input-gradient
backward, by the program's CUDA event pairs."""

from h100bench.span_share import share


def read(ctx):
    return share(ctx, "victim/swin/shift")
