"""run_stream's host loop, pipelined by one replay: after each read it
loads the next shadows and launches the next replay before it formats
and yields the folds it read.  Held here to a plain serial loop in the
order replay, read, format and yield, load, built from the engine's own
_advance, _fetch, _rows_from and _drain_load: the same folds in the same
order, from the same number of replays and reads.

This file imports no JAX.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rafft_tpu_torch import obs
from rafft_tpu_torch.engine import fold_torch as FT

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

CFG = FT.EngineConfig(N=32, K=3, R=4, M=12, V=32, CPLX=8, S=128,
                      max_branch=24, max_steps=8)


def _random(seed, count):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGU"), int(rng.integers(18, 33))))
            for _ in range(count)]


def _serial(eng, seqs, G):
    """(yields, replays) of the loop in the order replay, read, format
    and yield, then load the banked lanes' next shadows."""
    B, nseq = eng.B, len(seqs)
    nxt = min(B, nseq)
    lane_sid = np.full(B, -1)
    lane_sid[:nxt] = np.arange(nxt)

    def load(state, clear, lanes, lane_sid):
        nonlocal nxt
        placed, sid = [None] * B, np.full(B, -1, np.int32)
        loaded = np.zeros(B, bool)
        for b in lanes:
            if nxt < nseq:
                placed[b], sid[b], loaded[b] = seqs[nxt], nxt, True
                nxt += 1
            else:
                loaded[b] = lane_sid[b] >= 0
        codes, n = eng._encode(placed, B)
        return eng._drain_load(state, *(eng._t(x) for x in
                                        (clear, loaded, codes, n, sid)))

    state = eng.init_state(seqs[:B], seqids=lane_sid[:nseq])
    state = load(state, np.zeros(B, bool), range(B), lane_sid)
    out, replays = [], 0
    while len(out) < nseq:
        state = eng._advance(state, G)
        replays += 1
        got = dict(zip(eng._OUT_KEYS, eng._fetch(state, eng._OUT_KEYS)))
        pt, E, act, n, sid, flag, valid = (got[k] for k in (
            "out_pt", "out_E", "out_act", "out_n", "out_seqid", "out_flag",
            "out_valid"))
        fresh = np.flatnonzero(valid)
        for b in fresh:
            out.append((int(sid[b]), eng._rows_from(pt[b], E[b], act[b], n[b]),
                        int(flag[b])))
        if len(fresh):
            state = load(state, valid, fresh, got["seqid"])
    return out, replays


@pytest.mark.parametrize("B,count,G", [(3, 1, 2), (3, 3, 1), (2, 5, 2),
                                       (4, 9, 3), (2, 0, 2)])
def test_run_stream_yields_what_the_serial_loop_yields(B, count, G):
    """Fewer sequences than lanes, as many, more, and none: the same
    yields in the same order; one read a replay, as many replays as the
    serial loop, and every replay but the last launched ahead of its
    read's yields."""
    seqs = _random(100 + count, count)
    want, replays = _serial(FT.FoldEngine(CFG, B=B, device="cpu"), seqs, G)
    eng = FT.FoldEngine(CFG, B=B, device="cpu")
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = list(eng.run_stream(seqs, G))
    snap = obs.snapshot()
    assert got == want
    assert sorted(i for i, _, _ in got) == list(range(count))
    c = snap["counters"]
    assert c.get("stream.replays", 0) == replays
    assert c.get("stream.ahead", 0) == max(replays - 1, 0)
    reads = snap["spans"].get("engine.read", {}).get("calls", 0)
    assert reads == replays


@pytest.mark.parametrize("G", [1, 2])
def test_a_stream_closed_early_leaves_the_engine_as_a_fresh_one(G):
    """A consumer that closes the stream after its first yield leaves a
    replay launched and unread; a whole draw on the same engine then
    yields what a fresh engine yields."""
    first, second = _random(7, 6), _random(8, 5)
    eng = FT.FoldEngine(CFG, B=2, device="cpu")
    stream = eng.run_stream(first, G)
    next(stream)
    stream.close()
    got = list(eng.run_stream(second, G))
    assert got == list(FT.FoldEngine(CFG, B=2, device="cpu")
                       .run_stream(second, G))
    assert sorted(i for i, _, _ in got) == list(range(len(second)))
