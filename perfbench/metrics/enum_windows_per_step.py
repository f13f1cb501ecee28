"""enum_windows_per_step: the enumeration windows that a lane ran per
lane-step that enumerated, in the traced slice of a stream run (the
program's counters stream.enum_windows over stream.enum_steps: what the
lanes' running totals rose by between the drain's reads).  A step offers
each lane W windows of V combinations; a lane stops once it has counted
max_branch new structures or run out of combinations, so this reads how
many of the W the step needs, between 1 and W."""

from perfbench.program_trace import snapshot


def read(ctx):
    snap = snapshot(ctx, "stream")
    if snap is None:
        return None
    c = snap["counters"]
    if not c.get("stream.enum_steps") or "stream.enum_windows" not in c:
        return None
    return c["stream.enum_windows"] / c["stream.enum_steps"]
