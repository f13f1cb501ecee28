"""stream_live_lane_pct: the share of the batch's lanes folding a
sequence (neither done nor at the step limit) when a replay ended, over
the replays of a traced stream run (the program's counters
stream.live_lanes and stream.lanes)."""

from perfbench.program_trace import snapshot


def read(ctx):
    snap = snapshot(ctx, "stream")
    if snap is None or not snap["counters"].get("stream.lanes"):
        return None
    c = snap["counters"]
    return 100.0 * c.get("stream.live_lanes", 0) / c["stream.lanes"]
