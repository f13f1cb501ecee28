"""device_idle_pct.api: the share of a profiled slice of whole fold()
calls in which no kernel, copy or set ran on the card."""

from perfbench.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx, "fold_api")
