"""cplx_need_peak_pct: the most complex candidates that one step of a fold
drained in the traced slice of a stream run had, as a share of the
complex-candidate budget CPLX that the step evaluates in full (the
program's high-water counters stream.cplx_need_peak and
stream.cplx_budget), in %.  Above 100 a fold overflowed the budget and
was flagged; its distance below 100 is the budget's headroom."""

from perfbench.program_trace import snapshot


def read(ctx):
    snap = snapshot(ctx, "stream")
    if snap is None:
        return None
    c = snap["counters"]
    if not c.get("stream.cplx_budget") or "stream.cplx_need_peak" not in c:
        return None
    return 100.0 * c["stream.cplx_need_peak"] / c["stream.cplx_budget"]
