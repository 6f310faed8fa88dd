"""idle_share.learn: percent of the traced learning window in which the
card ran no kernel, copy or memset."""

from h100bench.readers import idle as read  # noqa: F401
