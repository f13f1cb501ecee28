"""The host-side parts of the port's measurement script, on the CPU.

rafft_tpu_torch/tools/measure.py runs on a CUDA card; what it computes on
the host (the row selection per bucket, the random nested tables it
feeds the loop analysis, and the reading of a profiler trace) is checked
here.
"""

import json

import numpy as np
import pytest

from rafft_tpu_torch.tools import measure as MS


@pytest.mark.parametrize("N,count,flagged", [(256, 32, []),
                                             (512, 16, [2268, 2269]),
                                             (1024, 4, [2293])])
def test_bucket_rows(N, count, flagged):
    rows = MS.journal()
    sel = MS.bucket_rows(rows, N, count)
    index = {id(r): i for i, r in enumerate(rows)}
    got = [index[id(r)] for r in sel]
    first = {256: 1938, 512: 2018, 1024: 2270}[N]
    assert got == list(range(first, first + count)) + flagged
    assert all(N // 2 < len(r["seq"]) <= N for r in sel)


def test_nested_tables_valid():
    codes, pt, n = MS.nested_tables(np.random.default_rng(7), 16, 256, 129, 256)
    pairs = {(1, 4), (4, 1), (2, 3), (3, 2), (3, 4), (4, 3)}
    for b in range(16):
        assert 129 <= n[b] <= 256
        assert (pt[b, n[b]:] == -1).all() and (codes[b, n[b]:] == 0).all()
        stack = []
        for i in range(n[b]):
            j = pt[b, i]
            if j < 0:
                continue
            assert pt[b, j] == i and (codes[b, min(i, j)],
                                      codes[b, max(i, j)]) in pairs
            if j > i:
                stack.append(i)
            else:
                assert stack.pop() == j and i - j > 3
        assert not stack
    assert (pt >= 0).sum() > 0


def test_trace_stats(tmp_path):
    """Kernels count toward the stage whose host range holds their
    launch; kernels launched outside every range count only in the
    total."""
    ev = []

    def kernel(corr, launch_ts, dur):
        ev.append(dict(cat="cuda_runtime", name="cudaLaunchKernel",
                       ts=launch_ts, dur=1, args=dict(correlation=corr)))
        ev.append(dict(cat="kernel", name="k", ts=launch_ts + 50, dur=dur,
                       args=dict(correlation=corr)))

    ev.append(dict(cat="user_annotation", name="rafft.stage.complex",
                   ts=100, dur=100))
    ev.append(dict(cat="user_annotation", name="rafft.stage.complex",
                   ts=400, dur=50))
    ev.append(dict(cat="user_annotation", name="rafft.stage.loops", ts=1000,
                   dur=10))
    # another of the program's ranges is no stage
    ev.append(dict(cat="user_annotation", name="rafft.engine.read", ts=250,
                   dur=100))
    kernel(1, 120, 2000)       # complex
    kernel(2, 410, 3000)       # complex, second range
    kernel(3, 300, 4000)       # between the ranges: no stage
    kernel(4, 1005, 1000)      # loops
    ev.append(dict(cat="gpu_memcpy", name="m", ts=2000, dur=500,
                   args=dict(correlation=5)))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(dict(traceEvents=ev)))
    kms, nops, stages = MS._trace_stats(str(path))
    assert nops == 5
    assert kms == pytest.approx(10.5)
    assert stages["complex"] == pytest.approx((5.0, 0.15, 2))
    assert stages["loops"] == pytest.approx((1.0, 0.01, 1))
    assert set(stages) == {"complex", "loops"}


def test_seeded_sequence():
    a = MS.seeded_sequence(2048, 1100, 2000)
    assert a == MS.seeded_sequence(2048, 1100, 2000) and set(a) == set("ACGU")
    assert 1100 <= len(a) <= 2000 and a != MS.seeded_sequence(2049, 1100, 2000)


def test_kernel_shapes_cover_every_bucket_and_k200():
    from rafft_tpu_torch.parallel.sweep import (DEFAULT_BUCKETS, bucket_batch,
                                                bucket_config)
    k50 = [s for s in MS.KERNEL_SHAPES if s[4] == 50]
    assert tuple(s[0] for s in k50) == DEFAULT_BUCKETS
    for N, nb, R, lens, K in MS.KERNEL_SHAPES:
        cfg = bucket_config(N, max(100, K), K, 1000)
        assert (nb, R) == (bucket_batch(16, N), cfg.R) and lens[1] <= N
    assert MS.KERNEL_SHAPES[-1][::4] == (128, 200)
    rows = {(s[0], s[4]): s[1] * s[4] for s in MS.KERNEL_SHAPES}
    assert rows[(2048, 50)] == 100 and rows[(4096, 50)] == 50
    assert rows[(128, 200)] == 3200


def test_first_difference_is_a_tie(monkeypatch):
    """Two engines of one configuration in lock-step: equal steps give
    None; a step that differs is accepted only when the lag ranks differ
    by less than the tolerance."""
    import torch
    from rafft_tpu_torch.engine import fold_torch as FT
    torch.set_num_threads(1)
    cfg = FT.EngineConfig(N=32, K=3, R=4, M=12, V=32, CPLX=16, S=128,
                          max_branch=32, max_steps=6, gc_wei=2.5, au_wei=1.7,
                          gu_wei=0.8)
    a = FT.FoldEngine(cfg, B=1, device="cpu")
    b = FT.FoldEngine(cfg, B=1, device="cpu")
    seqs = ["GGGAAACCCAAAGGGAAACCCUUUGGG"]
    assert MS.first_difference_is_a_tie(a, b, seqs, 2e-5) is None
    lags, cor = MS.lag_ranks(a, a.init_state(seqs))
    assert lags.shape == (1, 3, 4, 12) and cor.shape == (1, 3, 4, 63)
    assert torch.equal(lags[0, 0, 0, :1], cor[0, 0, 0].argmax(-1, True).int())

    # engine b ranks its lags by another correlation: noise of `scale`
    real = FT._correlate

    def noisy(scale):
        def fn(cfg_, W, rcodes, mlen, integral):
            cor = real(cfg_, W, rcodes, mlen, integral)
            g = torch.Generator().manual_seed(0)
            noise = torch.rand(cor.shape, generator=g) * scale
            return torch.where(cor > FT.NEG / 2, cor + noise, cor)
        return fn

    class Noisy(FT.FoldEngine):
        scale = 0.0

        def step(self, state):
            monkeypatch.setattr(FT, "_correlate", noisy(self.scale))
            try:
                return super().step(state)
            finally:
                monkeypatch.setattr(FT, "_correlate", real)

    b = Noisy(cfg, B=1, device="cpu")
    b.scale = 0.5          # reorders lags across real gaps
    with pytest.raises(AssertionError, match="agree|not by a tie"):
        MS.first_difference_is_a_tie(a, b, seqs, 2e-5)


def test_kept_counts_what_each_bound_keeps(monkeypatch):
    """The kept phase's bookkeeping, with the fold itself replaced by a
    call into the store: the same seeded calls at every bound, a larger
    bound never hits less, the store never holds more than the bound, and
    the bound is restored and the store emptied afterwards."""
    import torch
    from rafft_tpu_torch.engine import fold_torch as FT

    class Engine:
        _pool = None

        def __init__(self, cfg, B, device):
            self.cfg = cfg

    sizes = []

    def fold_one(seq, nb_mode, max_stack, max_branch, traj, device):
        cfg = FT.fold_one_config(len(seq), nb_mode, max_stack, max_branch)
        with FT._kept_engine(cfg, device):
            sizes.append(len(FT._kept))

    for name, fn in (("synchronize", lambda: None),
                     ("empty_cache", lambda: None),
                     ("memory_allocated", lambda: 0),
                     ("current_device", lambda: 0)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(FT, "FoldEngine", Engine)
    monkeypatch.setattr(FT, "fold_one", fold_one)
    FT.release_engines()
    recs = MS.phase_kept(calls=60, bounds=(1, 2, 8))
    assert FT.KEPT_ENGINES == 4 and not FT._kept
    assert max(sizes) <= 8 - 1       # taken out of the store while in use
    for order in ("corpus", "buckets"):
        hits = [recs[f"{order}.{b}"]["hit_pct"] for b in (1, 2, 8)]
        assert hits == sorted(hits) and 0 < hits[-1] < 100
        assert [recs[f"{order}.{b}"]["kept"] for b in (1, 2)] == [1, 2]
    # the corpus holds 7 buckets: at 8 only each one's first call misses
    assert recs["buckets.8"]["hit_pct"] == 100.0 * (60 - 7) / 60
