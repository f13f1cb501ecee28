"""The engines that fold() and fold_one() keep between calls
(fold_torch._kept_engine): a call at a configuration and device seen
before reuses that engine, whose answers equal fold_cpu's and those of an
engine built for the call; at most KEPT_ENGINES are kept, the least
recently used dropped first; release_engines() drops them all; a kept
engine serves one call at a time.

The engines fold on the CPU here, op by op; a kept engine's graphs on the
card are held in tests/test_torch_graph_cuda.py.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rafft_tpu_torch import obs, release_engines
from rafft_tpu_torch.engine import fold_cpu
from rafft_tpu_torch.engine import fold_torch as FT

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

_RNG = np.random.default_rng(16)
S32, S64, S128, S128_SHORT = ("".join(_RNG.choice(list("ACGU"), n))
                              for n in (30, 50, 100, 70))
NB, MB = 20, 50            # nb_mode, max_branch


@pytest.fixture(autouse=True)
def no_kept_engines():
    release_engines()
    yield
    release_engines()


def _beam(structs):
    return [(s.str_struct, s.energy, set(s.pair_list),
             [tuple(int(x) for x in a) for a in s.node_list])
            for s in structs]


def _answer(out, traj):
    """A fold's answer as data: the final beam, and with traj=True every
    step's beam, each structure with its pair set and node list."""
    if traj:
        final, steps = out
        return _beam(final), [_beam(b) for b in steps]
    return _beam(out)


def _fold(seq, max_stack, traj, entry="fold"):
    if entry == "fold":
        out = FT.fold(seq, NB, max_stack, MB, traj=traj, device="cpu")
    else:
        out = FT.fold_one(seq, NB, max_stack, MB, traj=traj, device="cpu")
    return _answer(out, traj)


def _fold_cpu(seq, max_stack, traj):
    return _answer(fold_cpu.fold(seq, NB, max_stack, MB, 3, 0.0, traj), traj)


def _fresh(seq, max_stack, traj, entry="fold"):
    """The answer of an engine built for this call alone."""
    eng = FT.FoldEngine(FT.fold_one_config(len(seq), NB, max_stack, MB),
                        B=1, device="cpu")
    out = eng.run([seq], collect_traj=traj, structures=entry == "fold")
    if entry == "fold_one":
        mk = lambda rows: [FT.Structure([], [], e, db) for db, e in rows]
    else:
        mk = lambda beam: beam
    return _answer((mk(out[0][0]), [mk(s[0]) for s in out[1]]) if traj
                   else mk(out[0][0]), traj)


def _rows(answer, traj):
    """The answer less its pair and node lists (fold_one leaves both
    empty)."""
    strip = lambda beam: [row[:2] for row in beam]
    if traj:
        return strip(answer[0]), [strip(b) for b in answer[1]]
    return strip(answer)


def _builds(monkeypatch):
    """Count the engines built from now on."""
    built = []
    init = FT.FoldEngine.__init__

    def counted(self, *args, **kw):
        built.append(args[0])
        init(self, *args, **kw)
    monkeypatch.setattr(FT.FoldEngine, "__init__", counted)
    return built


def _profiled(fn):
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    snap = obs.snapshot()
    obs.clear()
    return out, snap


def test_a_second_call_at_one_configuration_finds_the_engine_kept():
    first, snap = _profiled(lambda: _fold(S64, 2, True))
    assert snap["counters"].get("fold.engine_misses") == 1
    assert "fold.engine_hits" not in snap["counters"]
    assert snap["spans"]["engine.build"]["calls"] == 1
    second, snap = _profiled(lambda: _fold(S64, 2, True))
    assert snap["counters"].get("fold.engine_hits") == 1
    assert "fold.engine_misses" not in snap["counters"]
    assert "engine.build" not in snap["spans"]
    assert first == second == _fold_cpu(S64, 2, True)
    assert len(FT._kept) == 1


@pytest.mark.parametrize("entry", ["fold", "fold_one"])
def test_interleaved_calls_equal_fold_cpu_and_a_fresh_engine(entry,
                                                             monkeypatch):
    """Two buckets (N=64, N=128), two beam widths and traj on and off,
    in an order that goes back to each kept engine: each answer equals
    fold_cpu's and that of an engine built for the call."""
    calls = [(seq, ms, traj) for seq in (S64, S128_SHORT) for ms in (1, 3)
             for traj in (False, True)]
    want = {c: (_fold_cpu(*c), _fresh(*c, entry=entry)) for c in calls}
    order = [calls[i] for i in np.random.default_rng(7).permutation(
        len(calls))] + calls[::-1]
    built = _builds(monkeypatch)
    for c in order:
        got = _fold(*c, entry=entry)
        cpu, fresh = want[c]
        if entry == "fold":
            assert got == cpu == fresh, c
        else:
            assert got == fresh and _rows(got, c[2]) == _rows(cpu, c[2]), c
    # four configurations (traj takes no engine of its own), each built once
    assert len(built) == 4 == len(set(built)) == len(FT._kept)
    assert {cfg.N for cfg in built} == {64, 128}


def test_a_shorter_sequence_after_a_longer_one_in_its_bucket(monkeypatch):
    """Nothing of a longer fold stays in the kept engine for a shorter
    sequence of the same bucket, nor the other way round."""
    built = _builds(monkeypatch)
    long_ = _fold(S128, 3, True)
    short = _fold(S128_SHORT, 3, True)
    again = _fold(S128, 3, True)
    assert len(built) == 1 and built[0].N == 128
    assert short == _fold_cpu(S128_SHORT, 3, True) == _fresh(S128_SHORT, 3,
                                                              True)
    assert long_ == again == _fold_cpu(S128, 3, True)


def test_the_least_recently_used_engine_goes_first(monkeypatch):
    built = _builds(monkeypatch)
    widths = range(1, FT.KEPT_ENGINES + 2)
    for ms in widths:
        _fold(S32, ms, False, entry="fold_one")
        assert len(FT._kept) <= FT.KEPT_ENGINES
    assert [cfg.K for cfg in built] == list(widths)
    assert [cfg.K for cfg, _ in FT._kept] == list(widths)[1:]
    # a hit makes an engine the most recently used one ...
    _fold(S32, 2, False, entry="fold_one")
    assert len(built) == len(widths)
    # ... so the first width, built again, drops the third
    got = _fold(S32, 1, False, entry="fold_one")
    assert [cfg.K for cfg in built[len(widths):]] == [1]
    assert [cfg.K for cfg, _ in FT._kept] == [4, 5, 2, 1]
    assert len(FT._kept) == FT.KEPT_ENGINES
    assert _rows(got, False) == _rows(_fold_cpu(S32, 1, False), False)


def test_release_engines_drops_every_kept_engine(monkeypatch):
    built = _builds(monkeypatch)
    _fold(S32, 1, False)
    _fold(S64, 1, False)
    assert len(FT._kept) == 2
    release_engines()
    assert len(FT._kept) == 0
    _fold(S32, 1, False)
    assert [cfg.N for cfg in built] == [32, 64, 32]
    assert len(FT._kept) == 1


def test_the_device_is_part_of_the_key(monkeypatch):
    cfg = FT.fold_one_config(len(S32), NB, 1, MB)
    assert FT._engine_key(cfg, "cpu") == FT._engine_key(cfg,
                                                        torch.device("cpu"))
    # "cuda" is the current card's index, without a card made here
    monkeypatch.setattr(FT.torch.cuda, "current_device", lambda: 0)
    assert FT._engine_key(cfg, "cuda") == FT._engine_key(cfg, "cuda:0")
    assert FT._engine_key(cfg, "cuda") != FT._engine_key(cfg, "cuda:1")
    assert FT._engine_key(cfg, "cuda")[1] != torch.device("cpu")


def test_an_engine_in_use_is_not_handed_out(monkeypatch):
    """A call that wants its configuration's engine while another call
    holds it folds on an engine of its own; one engine stays kept."""
    cfg = FT.fold_one_config(len(S32), NB, 2, MB)
    _fold(S32, 2, True)
    kept = FT._kept[FT._engine_key(cfg, "cpu")]
    built = _builds(monkeypatch)
    with FT._kept_engine(cfg, "cpu") as eng:
        assert eng is kept
        got = _fold(S32, 2, True)
    assert len(built) == 1
    assert list(FT._kept.values()) == [kept]
    assert got == _fold_cpu(S32, 2, True)
    _fold(S32, 2, True)
    assert len(built) == 1


def test_an_engine_whose_call_raised_is_not_kept(monkeypatch):
    _fold(S32, 1, False)
    assert len(FT._kept) == 1
    run = FT.FoldEngine.run

    def broken(self, *a, **kw):
        raise RuntimeError("a failed call")
    monkeypatch.setattr(FT.FoldEngine, "run", broken)
    with pytest.raises(RuntimeError, match="a failed call"):
        _fold(S32, 1, False)
    assert len(FT._kept) == 0
    monkeypatch.setattr(FT.FoldEngine, "run", run)
    assert _fold(S32, 1, False) == _fold_cpu(S32, 1, False)
    assert len(FT._kept) == 1


def test_threads_folding_one_configuration_at_once(monkeypatch):
    """Four threads fold the same configuration at once, two calls each,
    with the interpreter switching threads often: every answer is
    right, and one engine is kept."""
    want = {seq: _fold_cpu(seq, 2, True) for seq in (S32, S64[:32])}
    seqs = list(want)
    built = _builds(monkeypatch)
    start = threading.Barrier(4, timeout=60)
    got, errors = [], []

    def worker(k):
        try:
            start.wait()
            for i in range(2):
                seq = seqs[(k + i) % 2]
                got.append((seq, _fold(seq, 2, True)))
        except Exception as exc:       # noqa: BLE001 (reported below)
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(got) == 8
    for seq, answer in got:
        assert answer == want[seq]
    assert 1 <= len(built) <= len(got)
    assert len(FT._kept) == 1
