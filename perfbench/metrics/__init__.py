"""Per-layer metric readers: one file a metric, perfbench/metrics/<name>.py,
loaded by path, each with `read(ctx) -> float | None`.  ctx holds what
the traced run gathered (the driver's readings: its name, the profiled
slice's SliceStats, rounds, folds or calls, host span seconds, the
wavefront call's region lengths).  A reader that finds nothing to read
returns None, and the metric is left out of the line."""


def idle_pct(ctx, driver):
    """The share of the profiled slice in which no device operation ran,
    in a run of `driver`."""
    s = ctx.get("slice")
    if ctx.get("driver") != driver or s is None or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def host_ms_per(ctx, driver, spans, per):
    """Host ms in the harness's spans `spans` per unit of ctx[per]."""
    if ctx.get("driver") != driver or not ctx.get(per):
        return None
    host = ctx["host_s"]
    return 1e3 * sum(host.get(name, 0.0) for name in spans) / ctx[per]
