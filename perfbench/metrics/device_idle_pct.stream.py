"""device_idle_pct.stream: the share of a profiled slice of a stream run
(whole replays and the host's drains between them) in which no kernel,
copy or set ran on the card."""

from perfbench.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx, "stream")
