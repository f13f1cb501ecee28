"""rslot_need_peak_pct: the most live regions that a new structure of a
fold drained in the traced slice of a stream run had, as a share of the
region slots R that each structure holds (the program's high-water
counters stream.rslot_need_peak and stream.rslots), in %.  Above 100 a
fold dropped regions and was flagged r_slots; its distance below 100 is
the slots' headroom."""

from perfbench.program_trace import snapshot


def read(ctx):
    snap = snapshot(ctx, "stream")
    if snap is None:
        return None
    c = snap["counters"]
    if not c.get("stream.rslots") or "stream.rslot_need_peak" not in c:
        return None
    return 100.0 * c["stream.rslot_need_peak"] / c["stream.rslots"]
