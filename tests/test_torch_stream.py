"""run_stream of the PyTorch fold engine against the JAX engine's, and
against its own run().

Continuous batching on two lanes over five sequences, so lanes bank
results and swap onto shadow sequences mid-flight; the yielded
(index, rows, flag) set must be equal.  (Its own file: the JAX engine's
streaming programs take most of a minute to compile on the CPU.)
"""

import numpy as np
import pytest
import torch

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu_torch.engine import fold_torch as FT

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)


CFG = dict(N=32, K=3, R=4, M=12, V=32, CPLX=8, S=128, max_branch=24,
           max_steps=8)


def test_run_stream_matches_jax():
    """B=2 lanes over 5 sequences: lanes swap onto shadows mid-flight."""
    cfg = CFG
    seqs = ["GGGAAACCCAAAGGGAAACCC", "GCGCUUCGGCGCGC",
            "GGGGAAAACCCCAAGGGGAAAACCCC", "ACGUACGUAGCUAGCUAGGCAU",
            "GGCGCAAGCCUUCGGGCUUGCGCC"]
    want = sorted(FJ.FoldEngine(FJ.EngineConfig(**cfg), B=2).run_stream(seqs))
    got = sorted(FT.FoldEngine(FT.EngineConfig(**cfg), B=2,
                               device="cpu").run_stream(seqs))
    assert [g[0] for g in got] == list(range(len(seqs)))
    assert got == want


@pytest.mark.parametrize("B,count", [(3, 1), (3, 3), (2, 5), (4, 9)])
def test_run_stream_yields_each_fold_as_run_folds_it_alone(B, count):
    """Fewer sequences than lanes, as many, and more: run_stream yields
    each index once, with the rows and flag that run() gives the sequence
    alone (its folds end within max_steps, so the step limit is never
    reached)."""
    rng = np.random.default_rng(count)
    seqs = ["".join(rng.choice(list("ACGU"), int(rng.integers(18, 33))))
            for _ in range(count)]
    cfg = FT.EngineConfig(**CFG)
    got = list(FT.FoldEngine(cfg, B=B, device="cpu").run_stream(seqs, G=2))
    assert sorted(i for i, _, _ in got) == list(range(count))
    alone = FT.FoldEngine(cfg, B=1, device="cpu")
    for i, rows, flag in got:
        beams, state = alone.run([seqs[i]])
        assert bool(state["done"][0]), i
        assert (rows, flag) == (beams[0], int(alone.flags(state)[0])), i
