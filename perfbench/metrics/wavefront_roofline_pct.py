"""wavefront_roofline_pct: the least time the card could take for the
wavefront kernel's calls in the profiled slice (perfbench/work.py, from
the region lengths each call scanned) over the kernel's device time
there, in percent.  Read only where every call in the slice has its
region lengths."""

from perfbench.work import least_seconds, wavefront_work

KERNEL = "wavefront_kernel"


def read(ctx):
    s, mlens = ctx.get("slice"), ctx.get("kernel_mlen")
    if s is None or not mlens:
        return None
    names = [k for k in s.op_s_by_name if KERNEL in k]
    device_s = sum(s.op_s_by_name[k] for k in names)
    calls = sum(s.op_n_by_name[k] for k in names)
    if device_s <= 0 or calls != len(mlens):
        return None
    least = sum(least_seconds(wavefront_work(m, ctx["N"])) for m in mlens)
    return 100.0 * least / device_s
