"""idle_share.attack: percent of the traced attack window in which the
card ran no kernel, copy or memset."""

from h100bench.readers import idle as read  # noqa: F401
