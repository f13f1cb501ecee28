"""The graphed fold path against the eager one, on a card.

FoldEngine replays one CUDA graph per G rounds on a card
(_advance_graphed, and _graphed over _steps); graphs=False runs the same
code eagerly, and tests/test_torch_graph_step.py holds that eager step
to the JAX engine on the CPU.  Here the two paths run on the same card
and must give equal states after every call, every key, bit for bit.
The tests are marked `cuda` and skip without a card; this file imports
no JAX, so it runs on the card's machine (tests/conftest.py imports JAX:
leave it out there):

    python -m pytest --noconftest tests/test_torch_graph_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from rafft_tpu_torch.engine import fold_torch as FT
from rafft_tpu_torch.engine import wavefront as WT

CFG32 = dict(N=32, K=50, R=8, M=32, V=256, W=4, CPLX=128, S=2048,
             max_branch=256, max_steps=10)
CFG64 = dict(N=64, K=50, R=8, M=48, V=256, W=4, CPLX=128, S=4096,
             max_branch=256, max_steps=10)
CFG64_K200 = dict(N=64, K=200, R=8, M=48, V=512, W=4, CPLX=512, S=6400,
                  max_branch=400, max_steps=10)


def _random(seed, count, lo, hi):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGU"), int(rng.integers(lo, hi))))
            for _ in range(count)]


# case: (configuration, sequences, what the run must show)
CASES = {
    "n32_k50": (CFG32, _random(32, 3, 20, 33), None),
    "n64_k50": (CFG64, _random(64, 3, 40, 65), None),
    "n64_k200": (CFG64_K200, _random(200, 1, 56, 61), None),
    # a row without a possible pair is done after its first step while
    # the other rows go on
    "dead_row": (CFG32, ["A" * 24] + _random(33, 2, 24, 33), "dead"),
    # a seen set of 40 slots overflows on the longer row only
    "seen_overflow": (dict(CFG32, S=40),
                      ["GGGAAACCCAUGC", "GGGGAAACCCCGGGGAAACCCCAAGGGAAACC"],
                      "overflow"),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs and the kernel have "
                    "no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n32_k50", "dead_row", "seen_overflow",
                                  "n64_k200"])
def test_graphed_advance_matches_eager(case):
    """_advance_graphed against _advance on the same card, every key of
    the state after every call of G rounds; the graph's replays count
    their kernel launches."""
    _card()
    cfg, seqs, _ = CASES[case]
    B = len(seqs)
    eager = FT.FoldEngine(FT.EngineConfig(**cfg), B=B, graphs=False)
    graph = FT.FoldEngine(FT.EngineConfig(**cfg), B=B)
    assert graph.graphs and not eager.graphs
    st_e = eager.init_state(seqs, seqids=list(range(B)))
    st_g = graph.init_state(seqs, seqids=list(range(B)))
    for call in range(4):
        st_e = eager._advance(st_e, 2)
        before = WT.LAUNCHES
        st_g = graph._advance_graphed(st_g, 2)
        torch.cuda.synchronize()
        # a replay launches the kernel once a round; the first call also
        # runs the warm-up round eagerly before the capture
        assert WT.LAUNCHES - before == (3 if call == 0 else 2)
        for k in st_e:
            assert torch.equal(st_g[k], st_e[k]), (case, call, k)


@pytest.mark.cuda
@pytest.mark.parametrize("count", [7, 2])
def test_graphed_stream_and_run_match_eager(count):
    """run_stream and run with graphs give the eager engine's beams and
    flags, on more sequences than the 3 lanes and on fewer."""
    _card()
    cfg = CFG64
    seqs = _random(5, 7, 30, 65)[:count]
    eager = FT.FoldEngine(FT.EngineConfig(**cfg), B=3, graphs=False)
    graph = FT.FoldEngine(FT.EngineConfig(**cfg), B=3)
    got = sorted(graph.run_stream(seqs))
    assert [i for i, _, _ in got] == list(range(count))
    assert got == sorted(eager.run_stream(seqs))
    beams_g, st_g = graph.run(seqs[:3])
    beams_e, st_e = eager.run(seqs[:3])
    assert beams_g == beams_e
    assert torch.equal(graph.flags(st_g), eager.flags(st_e))


@pytest.mark.cuda
def test_a_stream_closed_with_a_replay_in_flight_leaves_the_engine_sound():
    """run_stream launches the next replay before it yields a read's
    folds, so a consumer that closes the stream after its first yield
    leaves a replay in flight on the static buffers; a whole draw on the
    same engine then yields what a fresh engine yields."""
    _card()
    cfg = FT.EngineConfig(**CFG64)
    first, second = _random(9, 8, 30, 65), _random(10, 7, 30, 65)
    eng = FT.FoldEngine(cfg, B=3)
    stream = eng.run_stream(first)
    next(stream)
    stream.close()
    got = list(eng.run_stream(second))
    assert got == list(FT.FoldEngine(cfg, B=3).run_stream(second))
    assert sorted(i for i, _, _ in got) == list(range(len(second)))


def _answer(final, steps=()):
    beam = lambda structs: [
        (s.str_struct, s.energy, set(s.pair_list),
         [tuple(int(x) for x in a) for a in s.node_list]) for s in structs]
    return beam(final), [beam(b) for b in steps]


@pytest.mark.cuda
def test_a_kept_engine_captures_nothing_again(monkeypatch):
    """fold() at the api cell's settings (-ms 20, the CLI's -n 100
    --max_branch 1000) on three 128-bucket sequences: after the first
    call with and without a trajectory, the kept engine's graphs are
    replayed and nothing is captured again (wavefront.CAPTURED,
    FoldEngine._capture, the span engine.capture), and each answer, with
    its trajectory, pair and node lists, equals that of an engine built
    for the call."""
    from torch.profiler import ProfilerActivity, profile

    from rafft_tpu_torch import obs
    _card()
    FT.release_engines()
    seqs = _random(16, 3, 70, 129)
    kw = dict(nb_mode=100, max_stack=20, max_branch=1000, device="cuda")
    want = {}
    for seq in seqs:
        eng = FT.FoldEngine(FT.fold_one_config(len(seq), 100, 20, 1000), B=1)
        beams, steps, st = eng.run([seq], collect_traj=True, structures=True)
        assert int(eng.flags(st)[0]) == 0
        want[seq, True] = _answer(beams[0], [s[0] for s in steps])
        want[seq, False] = _answer(eng.run([seq], structures=True)[0][0])
    captures = []
    capture = FT.FoldEngine._capture

    def counted(self, body, G):
        captures.append((body.__name__, G))
        return capture(self, body, G)
    monkeypatch.setattr(FT.FoldEngine, "_capture", counted)
    refolds = FT.REFOLDS
    for traj in (True, False):
        got = FT.fold(seqs[0], traj=traj, **kw)
        assert (_answer(*got) if traj else _answer(got)) == \
            want[seqs[0], traj]
    assert sorted(captures) == [("_steps", 1), ("_steps", 4)]
    captured = WT.CAPTURED
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for seq in seqs[1:]:
            for traj in (True, False):
                got = FT.fold(seq, traj=traj, **kw)
                torch.cuda.synchronize()
                assert (_answer(*got) if traj else _answer(got)) == \
                    want[seq, traj], (seq, traj)
    snap = obs.snapshot()
    obs.clear()
    assert WT.CAPTURED == captured and len(captures) == 2
    assert FT.REFOLDS == refolds
    assert snap["counters"].get("fold.engine_hits") == 4
    assert "fold.engine_misses" not in snap["counters"]
    for name in ("engine.build", "engine.warmup", "engine.capture"):
        assert name not in snap["spans"], name
    assert snap["spans"]["engine.launch"]["calls"] > 0
    assert len(FT._kept) == 1
    FT.release_engines()
