"""host_syncs.attack: the program's blocking host reads of device data
(its ``sync/*`` spans, recorded while the window is traced) per attacked
batch. None where the program records no ``adil/forward`` span."""

from dl_attack_on_imagenet_tpu_torch.utils import profiling


def read(ctx):
    if not ctx.on_device or not ctx.units or not hasattr(profiling, "totals"):
        return None
    totals = profiling.totals()
    if "adil/forward" not in totals:
        return None
    return sum(t.count for name, t in totals.items() if name.startswith("sync/")) / ctx.units
