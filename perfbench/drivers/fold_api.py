"""Entry driver `fold_api`: the package's public `fold`, one sequence a
call, as a user folding one RNA and reading its folding path calls it.

A closed loop of one client with no think time: each request is one
call of `rafft_tpu_torch.fold` on the next sequence of the draw, with the
configuration's settings (`traj` included) on the card.  Each call
builds its own FoldEngine, warms it up, captures its graph and replays
it; the call is timed on the host clock until its answer is on the host.
A call that `fold` answers on the host instead (a fold the engine
flagged, counted in fold_torch.REFOLDS) counts as failed: the card did
not answer it.

Traced, the harness also wraps FoldEngine.__init__ and
FoldEngine._capture (the engine a call builds) and
FoldEngine._structures (the trajectory's read) at class level, from the
window's start to its end, so the spans hold the window's calls alone.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench import check
from perfbench.drivers import Window, peak_allocated, sync

CLASS_SPANS = ("__init__", "_capture", "_structures")
SETTINGS = ("nb_mode", "max_stack", "max_branch", "min_hp", "min_nrj",
            "traj", "temp", "gc_wei", "au_wei", "gu_wei")


def answer_form(settings):
    """The canonical form of this driver's answers (perfbench/check.py)."""
    return "trajectory" if settings["traj"] else "structures"


class Cell:
    def __init__(self, settings, workload, device, spans=None):
        from rafft_tpu_torch.engine import fold_torch
        self.FT = fold_torch
        self.device = device
        self.kw = {k: settings[k] for k in SETTINGS}
        self.trace_after_s = workload["trace_after_s"]
        self.trace_calls = workload["trace_calls"]
        self.spans = spans
        self._orig = {}

    def _call(self, seq):
        return self.FT.fold(seq, device=self.device, **self.kw)

    def warm(self, seqs):
        for seq in seqs:
            self._call(seq)

    def window(self, seqs, seconds, slice_=None) -> Window:
        if self.spans is not None:
            cls = self.FT.FoldEngine
            for name in CLASS_SPANS:
                self._orig[name] = getattr(cls, name)
                setattr(cls, name, self.spans.wrap(name, self._orig[name]))
        refolds0 = self.FT.REFOLDS
        times, outs = [], []
        in_slice = 0
        t0 = time.perf_counter()
        for seq in seqs:
            if slice_ is not None and not slice_.active and not in_slice \
                    and time.perf_counter() - t0 >= self.trace_after_s:
                slice_.start()
            t = time.perf_counter()
            outs.append(self._call(seq))
            sync(self.device)
            times.append(time.perf_counter() - t)
            if slice_ is not None and slice_.active:
                in_slice += 1
                if in_slice >= self.trace_calls:
                    slice_.stop()
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        if slice_ is not None and slice_.active:
            slice_.stop()
        self.close()
        refolds = self.FT.REFOLDS - refolds0
        if self.kw["traj"]:
            answers = [check.canon_trajectory(*o) for o in outs]
        else:
            answers = [check.canon_structures(o) for o in outs]
        ms = np.asarray(times) * 1e3
        out = Window(
            attempted=len(outs), failed=refolds,
            answered=list(zip(seqs, answers)),
            wall_s=wall,
            metrics={"fold_p50_ms": (float(np.percentile(ms, 50)), "ms")},
            peak_bytes=peak_allocated(self.device))
        out.readings["refolded_calls"] = refolds
        if slice_ is not None:
            out.readings.update(driver="fold_api", slice=slice_.stats,
                                calls=len(outs),
                                host_s=dict(self.spans.seconds))
        return out

    def close(self):
        for name, fn in self._orig.items():
            setattr(self.FT.FoldEngine, name, fn)
        self._orig.clear()
