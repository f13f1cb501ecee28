"""The program's own trace: named host spans, counters and the fold step's
stage clocks, recorded while torch.profiler records and only then.

There is no switch of its own: each span, counter and stage mark asks
`recording()` (torch.autograd._profiler_enabled, one call) and does
nothing more when the profiler is off.  While it records:

- `span(name)` is a `torch.profiler.record_function` range
  "rafft.<name>" (on the profiler's clock, beside the device's kernels)
  whose time (time.time_ns) is added to the span's sums;
- `count(name, n=1)` adds to a counter, `high(name, value)` raises a
  high-water counter to the largest value it is given;
- the fold step marks its stage boundaries on a stage clock: run op by op
  (`HostStages`) each stage is a span "stage.<name>"; captured into a
  CUDA graph (`GraphStages`) each boundary is a timing event recorded by
  the graph itself, so every replay refills it, and the engine adds up
  the stages' device ms (`GraphStages.read`) after the host read that
  waited for the replay.

`snapshot()` sums what was recorded since the last `clear()`: each span's
calls, total and self seconds (the span less its child spans), the
counters, the stages' device ms, and the program's process-wide counters,
which their own modules register (`process_counter`: each hand kernel's
launches and captures, fold()'s refolds).  The ranges themselves are the
profiler's.  The trace is one per process, like the profiler it follows;
spans nest per thread.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch

PREFIX = "rafft."

recording = torch.autograd._profiler_enabled

_spans = defaultdict(lambda: [0, 0, 0])    # name -> [calls, total_ns, self_ns]
_counters = defaultdict(int)
_stage_ms = defaultdict(float)
_process = {}                               # name -> its reader
_local = threading.local()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


_OFF = contextlib.nullcontext()       # the span of a call while nothing records


class _Span:
    __slots__ = ("name", "start", "child", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.child = 0
        self.start = time.time_ns()
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        self.range.__exit__(None, None, None)
        end = time.time_ns()
        stack = _stack()
        if self in stack:
            # a span that an exception left open above this one is dropped
            while stack.pop() is not self:
                pass
        dur = end - self.start
        tot = _spans[self.name]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - self.child
        if stack:
            stack[-1].child += dur
        return False


def span(name):
    """A context manager: the span `name` while recording, else nothing."""
    return _Span(name) if recording() else _OFF


def count(name, n=1):
    """Add n to the counter `name` while recording."""
    if recording():
        _counters[name] += n


def high(name, value):
    """Raise the high-water counter `name` to `value` while recording:
    it holds the largest value given since the last clear()."""
    if recording() and (name not in _counters or value > _counters[name]):
        _counters[name] = value


def process_counter(name, read):
    """Register the process-wide counter `name`, which counts whether or
    not the profiler records: snapshot()["process"][name] is read()."""
    _process[name] = read


class HostStages:
    """The stage clock of a step run op by op: `to(name)` ends the open
    stage and, while recording, opens the span "stage.<name>" (the open
    stage goes on where it is `name` already); `to(None)` ends it.
    `round()` counts a step whose stages were recorded."""

    def __init__(self):
        self._open = None

    @property
    def idle(self):
        return self._open is None

    def to(self, name):
        if self._open is not None:
            if name is not None and self._open.name == "stage." + name:
                return
            self._open.__exit__(None, None, None)
            self._open = None
        if name is not None and recording():
            self._open = _Span("stage." + name).__enter__()

    def round(self):
        count("stage.rounds")


class GraphStages:
    """The stage clock of a CUDA graph's capture: `to(name)` records a
    timing event into the graph (an event node, not a kernel) that starts
    stage `name`, or with None ends the open stage (nothing where the
    stage is open already, or none is); `round()` counts the
    steps the graph holds.  After a replay has finished, `read()` adds
    each stage's device ms between its events, and the graph's rounds to
    "stage.rounds"."""

    def __init__(self):
        self.marks = []          # (stage that starts at the event or None, event)
        self.rounds = 0

    @property
    def idle(self):
        return not self.marks or self.marks[-1][0] is None

    def to(self, name):
        if (name is None and self.idle) or (
                self.marks and self.marks[-1][0] == name):
            return
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.marks.append((name, ev))

    def round(self):
        self.rounds += 1

    def resume(self):
        """Open again the stage that was open last."""
        last = [name for name, _ in self.marks if name is not None]
        if last:
            self.to(last[-1])

    def read(self):
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            if name is not None:
                _stage_ms[name] += a.elapsed_time(b)
        count("stage.rounds", self.rounds)


def snapshot():
    """What was recorded since the last clear():

    spans     {name: {"calls", "total_s", "self_s"}}
    counters  {name: count, or a high-water counter's largest value}
    stage_ms  {stage: device ms} (graph replays only)
    process   the registered process-wide counters (process_counter):
              each hand kernel's launches and captured launches, fold()
              calls refolded on the host
    """
    return dict(
        spans={k: dict(calls=c, total_s=t / 1e9, self_s=s / 1e9)
               for k, (c, t, s) in _spans.items()},
        counters=dict(_counters), stage_ms=dict(_stage_ms),
        process={k: read() for k, read in _process.items()})


def clear():
    """Forget every span sum, counter and stage sum."""
    _spans.clear()
    _counters.clear()
    _stage_ms.clear()
