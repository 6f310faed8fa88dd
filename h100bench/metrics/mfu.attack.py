"""mfu.attack: the victim's model FLOPs in the attack window over the
fp32 peak (percent); see ``readers.mfu``."""

from h100bench.readers import mfu as read  # noqa: F401
