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
def test_graphed_stream_and_run_match_eager():
    """run_stream and run with graphs give the eager engine's beams and
    flags."""
    _card()
    cfg = CFG64
    seqs = _random(5, 7, 30, 65)
    eager = FT.FoldEngine(FT.EngineConfig(**cfg), B=3, graphs=False)
    graph = FT.FoldEngine(FT.EngineConfig(**cfg), B=3)
    assert sorted(graph.run_stream(seqs)) == sorted(eager.run_stream(seqs))
    beams_g, st_g = graph.run(seqs[:3])
    beams_e, st_e = eager.run(seqs[:3])
    assert beams_g == beams_e
    assert torch.equal(graph.flags(st_g), eager.flags(st_e))
