"""host_step_ms.attack: the host's time for one solver iteration, in ms:
the median self time of the window's ``adil/ddrague/step`` and
``adil/sample/trial`` spans, so without the iteration's blocking read (a
child span). None where the program records neither span."""

import statistics

from dl_attack_on_imagenet_tpu_torch.utils import profiling

SPANS = ("adil/ddrague/step", "adil/sample/trial")


def read(ctx):
    if not ctx.on_device or not hasattr(profiling, "spans"):
        return None
    own = [s.self_ns for s in profiling.spans() if s.name in SPANS]
    return statistics.median(own) / 1e6 if own else None
