"""fused_perturb_roofline: the least time for the window's read-offs of
adversaries (clip(x + clamp(v D, ±eps), 0, 1): v, D and x read once and
the adversary written once, fp32, at the HBM rate) over the device time of
the kernel that performs them (percent). DDrague reads off once a batch;
unsupervised sampling once a trial."""

from h100bench import arith
from h100bench.readers import image_size, roofline

KERNELS = ("fused_perturb_kernel",)


def read(ctx):
    mix = ctx.mix
    calls = ctx.units * (1 if mix["mode"] == "supervised" else mix["trials"])
    per_call = arith.fused_perturb_bytes(mix["batch"], ctx.config["attack"]["n_atoms"],
                                         image_size(ctx.config))
    return roofline(ctx, calls * per_call, KERNELS)
