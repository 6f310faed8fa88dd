"""host_syncs.learn: the learning job's blocking host reads of device data
(its ``sync/*`` spans, recorded from the job's thread while the window is
traced) per epoch. None where the program records no ``adil/step`` span."""

from dl_attack_on_imagenet_tpu_torch.utils import profiling


def read(ctx):
    if not ctx.on_device or not ctx.units or not hasattr(profiling, "totals"):
        return None
    totals = profiling.totals()
    if "adil/step" not in totals:
        return None
    return sum(t.count for name, t in totals.items() if name.startswith("sync/")) / ctx.units
