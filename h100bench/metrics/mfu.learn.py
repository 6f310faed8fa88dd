"""mfu.learn: the victim's model FLOPs in the learning window over the
fp32 peak (percent); see ``readers.mfu``."""

from h100bench.readers import mfu as read  # noqa: F401
