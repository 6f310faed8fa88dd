"""fused_adamw_project_roofline: the least time for the AdamW-and-clamp
updates of D and of v that the window's steps need (each element of p, g,
mu, nu read once and of p, mu, nu written once, fp32, at the HBM rate) over
the device time of the kernels that perform them (percent)."""

from h100bench import arith
from h100bench.readers import image_size, roofline, train_steps

KERNELS = ("fused_adamw_project_kernel",)


def read(ctx):
    k, n = ctx.config["attack"]["n_atoms"], ctx.mix["images"]
    per_step = arith.fused_adamw_project_bytes(k * image_size(ctx.config)) \
        + arith.fused_adamw_project_bytes(n * k)
    return roofline(ctx, train_steps(ctx) * per_step, KERNELS)
