"""What a traced run reads: host spans the harness places around calls
into the program, and a bounded slice of the window under torch.profiler,
kept in memory and reduced to a summary (no trace file is written).

Spans: `Spans.wrap` times a callable on the host and marks it with a
profiler range "perfbench:<name>", so the slice can say what the host was
doing while the device was idle.

Slice: `Slice.start()` / `stop()` bracket whole calls into the program
(the device is idle at both ends); `stop()` returns a `SliceStats`: the
slice's length, the time the device was busy in it (the union of its
kernel, copy and set intervals), kernel time by name, which kernels a
CUDA graph launched, and the device's idle gaps by host span.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

SPAN = "perfbench:"
SLICE = "perfbench.slice"
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
BREAKDOWN_ENTRIES = 10


class Spans:
    """Host seconds of wrapped callables, by span name."""

    def __init__(self):
        self.seconds = defaultdict(float)

    def wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(SPAN + name):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.seconds[name] += time.perf_counter() - t0
        wrapped.__name__ = getattr(fn, "__name__", name)
        return wrapped


@dataclass
class SliceStats:
    window_s: float
    busy_s: float
    kernels: int
    graph_kernel_s: float
    graph_kernels: int
    op_s_by_name: dict = field(default_factory=dict)
    op_n_by_name: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


class Slice:
    """One profiled slice of a run (CPU and, on a card, CUDA activities)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.mark = None
        self.stats = None

    @property
    def active(self):
        return self.prof is not None

    def warm(self):
        """Start and stop the profiler once, so that its first start (the
        CUDA tracing library's set-up: seconds) falls in set-up, not in
        the window."""
        self.start()
        self.stop()
        self.stats = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(SLICE)
        self.mark.__enter__()
        self.host_s = time.perf_counter()

    def stop(self):
        """End the slice; its SliceStats are then in `stats`."""
        if self.cuda:
            torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.host_s = time.perf_counter() - self.host_s
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        self.prof = self.mark = None
        self.stats = summarise(events)
        # the profiler drops what overflows its buffers, and then closes
        # the slice's own range early: keep no reading of a cut slice
        if self.stats.window_s < 0.95 * self.host_s:
            raise RuntimeError(
                f"the profiler kept {self.stats.window_s:.3f} s of a "
                f"{self.host_s:.3f} s slice: shorten the slice")


def _kind(ev):
    """"kernel", "gpu_memcpy", "gpu_memset", or None (a range the
    profiler mirrors on the device) of a device event."""
    name = ev.name()
    if name == SLICE or name.startswith(SPAN) \
            or getattr(ev, "is_user_annotation", lambda: False)():
        return None
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _union(intervals):
    """Merged, sorted intervals of [(lo, hi)]."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def summarise(events) -> SliceStats:
    """Reduce the slice's kineto events to a SliceStats (seconds)."""
    host, device, graph_launches = [], [], set()
    lo = hi = None
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            kind = _kind(ev)
            if kind is not None:
                device.append((ev.start_ns(), ev.end_ns(), ev.name(), kind,
                               ev.correlation_id()))
            continue
        name = ev.name()
        if name == SLICE:
            lo, hi = ev.start_ns(), ev.end_ns()
        elif name.startswith(SPAN):
            host.append((ev.start_ns(), ev.end_ns(), name[len(SPAN):]))
        elif name in GRAPH_LAUNCHES:
            graph_launches.add(ev.correlation_id())
    if lo is None:
        raise RuntimeError("the profiled slice has no range of its own")
    inside = [(max(a, lo), min(b, hi), name, kind, corr)
              for a, b, name, kind, corr in device if b > lo and a < hi]
    busy = _union([(a, b) for a, b, *_ in inside])
    kern = [(b - a, name, corr) for a, b, name, kind, corr in inside
            if kind == "kernel"]
    graph = [d for d, _, corr in kern if corr in graph_launches]
    by_name, n_by_name = defaultdict(float), defaultdict(int)
    for a, b, name, *_ in inside:
        by_name[name] += (b - a) / 1e9
        n_by_name[name] += 1

    # idle gaps, each put down to the harness span open on the host at its
    # midpoint (the spans do not nest)
    host.sort()
    starts = [a for a, _, _ in host]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = defaultdict(float)
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        at = bisect.bisect_right(starts, mid) - 1
        name = (host[at][2] if at >= 0 and mid < host[at][1]
                else "outside the harness's spans")
        gaps[name] += (b - a) / 1e9
    top = lambda d: sorted(([k[:160], v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    return SliceStats(
        window_s=(hi - lo) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9,
        kernels=len(kern),
        graph_kernel_s=sum(graph) / 1e9, graph_kernels=len(graph),
        op_s_by_name=dict(by_name), op_n_by_name=dict(n_by_name),
        device_ops=top(by_name), idle_gaps=top(gaps))
