"""host_step_ms.learn: the host's time for one training step, in ms: the
median self time of the window's ``adil/step`` spans in the job's thread.
The median leaves out the first step of each epoch, in which the benchmark
holds the job until it asks for the next epoch. None where the program
records no ``adil/step`` span."""

import statistics

from dl_attack_on_imagenet_tpu_torch.utils import profiling


def read(ctx):
    if not ctx.on_device or not hasattr(profiling, "spans"):
        return None
    own = [s.self_ns for s in profiling.spans() if s.name == "adil/step"]
    return statistics.median(own) / 1e6 if own else None
