"""Entry driver `stream`: the corpus sweep's fold path.

One FoldEngine at the sweep's configuration of the cell's bucket
(parallel/sweep.py: bucket_config, bucket_batch) folds the draw through
`run_stream`: continuous batching, on a card one CUDA graph replay of G
swap+step rounds between host reads.  The draw is longer than the window
can fold; the window stops taking results at its end.  A fold the engine
flags leaves the card without an exact answer (the sweep would refold it
on the host), so it counts as failed.

Traced, the harness also wraps the engine instance's `_advance_graphed`
(replays, so rounds = replays x G), `_rows_from`, `_encode`,
`_drain_load` and `_fetch` (host spans), and the step's wavefront call:
at the capture it keeps the region-length tensor each captured call
reads, whose memory every replay then refills, to count the kernel's
work.
"""

from __future__ import annotations

import time

import torch

from perfbench import check
from perfbench.drivers import Window, peak_allocated, sync

HOST_SPANS = ("_rows_from", "_encode", "_drain_load", "_fetch")


def answer_form(settings):
    """The canonical form of this driver's answers (perfbench/check.py)."""
    return "rows"


class Cell:
    def __init__(self, settings, workload, device, spans=None):
        from rafft_tpu_torch.engine import fold_torch
        from rafft_tpu_torch.parallel.sweep import bucket_batch, bucket_config
        N = workload["bucket"]
        self.cfg = bucket_config(N, settings["nb_mode"], settings["max_stack"],
                                 settings["max_branch"])
        for key in ("min_hp", "min_nrj", "temp", "gc_wei", "au_wei", "gu_wei"):
            if getattr(self.cfg, key) != settings[key]:
                raise ValueError(f"bucket_config sets {key}="
                                 f"{getattr(self.cfg, key)}, the configuration "
                                 f"states {settings[key]}")
        self.device = device
        self.G = workload["rounds_per_replay"]
        self.trace_after_s = workload["trace_after_s"]
        self.trace_replays = workload["trace_replays"]
        self.spans = spans
        self.FT = fold_torch
        self.kernel_mlen = []            # region lengths a capture keeps
        self._kernel_call = fold_torch.wavefront_tables
        if spans is not None:
            fold_torch.wavefront_tables = self._spy
        self.eng = fold_torch.FoldEngine(
            self.cfg, B=bucket_batch(workload["batch"], N), device=device)

    def _spy(self, cfg, tabs, rcodes, rpos, mlen, *args, **kwargs):
        if rcodes.is_cuda and torch.cuda.is_current_stream_capturing():
            self.kernel_mlen.append(mlen)
        return self._kernel_call(cfg, tabs, rcodes, rpos, mlen, *args,
                                 **kwargs)

    def warm(self, seqs):
        for _ in self.eng.run_stream(seqs, self.G):
            pass

    def window(self, seqs, seconds, slice_=None) -> Window:
        eng, spans = self.eng, self.spans
        replays, mlens = [0], []
        if spans is not None:
            for name in HOST_SPANS:
                setattr(eng, name, spans.wrap(name, getattr(eng, name)))
            advance = spans.wrap("replay", eng._advance_graphed)

            def counted(state, G):
                out = advance(state, G)
                if slice_.active:
                    replays[0] += 1
                    mlens.extend(m.cpu().numpy() for m in self.kernel_mlen)
                return out
            eng._advance_graphed = counted

        done = []                         # (draw index, rows, flag)
        started = slice_ is None          # the slice, if any, has begun
        t0 = time.perf_counter()
        stream = eng.run_stream(seqs, self.G)
        for item in stream:
            done.append(item)
            now = time.perf_counter() - t0
            if now >= seconds:
                break
            if slice_ is not None and slice_.active:
                if replays[0] >= self.trace_replays:
                    slice_.stop()
            elif not started and now >= self.trace_after_s:
                slice_.start()
                started = True
        stream.close()
        sync(self.device)
        wall = time.perf_counter() - t0
        if slice_ is not None and slice_.active:
            slice_.stop()

        good = sum(flag == 0 for _, _, flag in done)
        out = Window(
            attempted=len(done), failed=len(done) - good,
            answered=[(seqs[i], check.canon_rows(rows, flag))
                      for i, rows, flag in done],
            wall_s=wall, metrics={"seq_per_s": (good / wall, "seq/s")},
            failed_at=[k for k, (_, _, flag) in enumerate(done) if flag],
            peak_bytes=peak_allocated(self.device) + self.pool_bytes())
        if slice_ is not None:
            out.readings.update(
                driver="stream", slice=slice_.stats, N=self.cfg.N,
                rounds=replays[0] * self.G, kernel_mlen=mlens,
                folds=len(done), host_s=dict(spans.seconds))
        return out

    def pool_bytes(self):
        """Bytes of the segments of the engine's CUDA graph pool: free
        between replays, so max_memory_allocated does not count them."""
        if self.eng._pool is None:
            return 0
        pool = tuple(self.eng._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def close(self):
        self.FT.wavefront_tables = self._kernel_call
        self.kernel_mlen.clear()
        self.eng = None
