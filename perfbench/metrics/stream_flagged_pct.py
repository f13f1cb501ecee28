"""stream_flagged_pct: the share of the folds drained in the traced slice
of a stream run that the engine flagged as possibly inexact, any cause
(the program's counters stream.flagged and stream.folds), in %.  A
flagged fold is no answer: the sweep refolds it on the host."""

from perfbench.program_trace import snapshot


def read(ctx):
    snap = snapshot(ctx, "stream")
    if snap is None:
        return None
    c = snap["counters"]
    if "stream.flagged" not in c or not c.get("stream.folds"):
        return None
    return 100.0 * c["stream.flagged"] / c["stream.folds"]
