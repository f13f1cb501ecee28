"""api_engine_hit_pct: the share of fold() calls of a traced fold_api run
that found their configuration's engine kept (the program's counters
fold.engine_hits and fold.engine_misses), in %."""

from perfbench.program_trace import snapshot


def read(ctx):
    snap = snapshot(ctx, "fold_api")
    if snap is None:
        return None
    c = snap["counters"]
    hits, misses = c.get("fold.engine_hits", 0), c.get("fold.engine_misses", 0)
    if not hits + misses:
        return None
    return 100.0 * hits / (hits + misses)
