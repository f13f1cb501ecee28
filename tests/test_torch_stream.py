"""run_stream of the PyTorch fold engine against the JAX engine's.

Continuous batching on two lanes over five sequences, so lanes bank
results and swap onto shadow sequences mid-flight; the yielded
(index, rows, flag) set must be equal.  (Its own file: the JAX engine's
streaming programs take most of a minute to compile on the CPU.)
"""

import torch

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu_torch.engine import fold_torch as FT

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def test_run_stream_matches_jax():
    """B=2 lanes over 5 sequences: lanes swap onto shadows mid-flight."""
    cfg = dict(N=32, K=3, R=4, M=12, V=32, CPLX=8, S=128, max_branch=24,
               max_steps=8)
    seqs = ["GGGAAACCCAAAGGGAAACCC", "GCGCUUCGGCGCGC",
            "GGGGAAAACCCCAAGGGGAAAACCCC", "ACGUACGUAGCUAGCUAGGCAU",
            "GGCGCAAGCCUUCGGGCUUGCGCC"]
    want = sorted(FJ.FoldEngine(FJ.EngineConfig(**cfg), B=2).run_stream(seqs))
    got = sorted(FT.FoldEngine(FT.EngineConfig(**cfg), B=2,
                               device="cpu").run_stream(seqs))
    assert [g[0] for g in got] == list(range(len(seqs)))
    assert got == want
