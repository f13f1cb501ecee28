"""The 2048/4096 buckets on the CPU: a cut-configuration fold and the
state carried across.

The JAX engine takes minutes to compile at N=2048 on the CPU, so the
whole fold is held to the port's sequential parity engine fold_cpu (which
tests/test_torch_oracle.py holds equal to the JAX package's).  The
engine's plain wavefront costs one pass of tensor operations per region
position and step on the CPU, so the configuration is cut to K=2, R=12,
M=20, max_branch=100, and the seeded sequence (1,080 nt: three imperfect
hairpins with mutated arms, so that regions shrink fast) folds in ten
steps.  chip_smoke.py folds random sequences of 1,100 to 2,000 nt and the
two 23S rRNAs of the corpus at the sweep's full configurations on the
card.
"""

import numpy as np
import pytest
import torch

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu_torch.convert import state_from_numpy, state_to_numpy
from rafft_tpu_torch.engine import fold_cpu
from rafft_tpu_torch.engine import fold_torch as FT
from rafft_tpu_torch.engine import wavefront as WT
from rafft_tpu_torch.parallel import sweep as TS

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def hairpin_sequence(seed, count=3, arm=170, loop=8, mut=0.08, spacer=12):
    """`count` hairpins: a random arm, a loop, the arm's reverse
    complement with a share `mut` of point mutations, a spacer."""
    rng = np.random.default_rng(seed)
    comp = dict(A="U", U="A", G="C", C="G")
    out = []
    for _ in range(count):
        a = rng.choice(list("ACGU"), arm)
        b = [rng.choice(list("ACGU")) if rng.random() < mut else comp[x]
             for x in a[::-1]]
        out += [*a, *rng.choice(list("ACGU"), loop), *b,
                *rng.choice(list("AC"), spacer)]
    return "".join(out)


def test_cut_configuration_fold_past_1024_matches_fold_cpu():
    seq = hairpin_sequence(2048)
    assert 1024 < len(seq) <= 2048
    want = [(s.str_struct, s.energy)
            for s in fold_cpu.fold(seq, nb_mode=20, max_stack=2,
                                   max_branch=100)]
    cfg = FT.EngineConfig(N=2048, K=2, M=20, R=12, max_branch=100, V=256,
                          W=8, CPLX=64, S=4096, max_steps=100)
    eng = FT.FoldEngine(cfg, B=1, device="cpu")
    longest, real = [], FT.wavefront_tables

    def spy(*args):
        WT.check_layout(*args)
        longest.append(int(args[4].max()))
        return real(*args)

    FT.wavefront_tables = spy
    try:
        out = list(eng.run_stream([seq]))
    finally:
        FT.wavefront_tables = real
    assert [(i, flag) for i, _, flag in out] == [(0, 0)]
    assert out[0][1] == want
    assert want[0][1] < -500 and want[0][0].count("(") > 400
    # the first step's region is the whole sequence: positions past 1024
    assert longest[0] == len(seq) and len(longest) >= 5


@pytest.mark.parametrize("N,K,weights", [(2048, 50, (3.0, 2.0, 1.0)),
                                         (4096, 50, (2.5, 1.7, 0.8)),
                                         (128, 200, (3.0, 2.0, 1.0))])
def test_jax_states_carry_over_at_the_new_configurations(N, K, weights):
    """state_from_numpy / state_to_numpy keep every field's dtype and
    shape of a JAX engine state at N = 2048 and 4096, K = 200 and
    non-integral weights, and the port's own init_state agrees."""
    gc, au, gu = weights
    kw = dict(nb_mode=200 if K == 200 else 100, max_stack=K, max_branch=1000)
    cfg = TS.bucket_config(N, **kw)
    jcfg = FJ.EngineConfig(**{**vars(cfg), "gc_wei": gc, "au_wei": au,
                              "gu_wei": gu})
    tcfg = FT.EngineConfig(**vars(jcfg))
    B = TS.bucket_batch(16, N)
    rng = np.random.default_rng(N + K)
    seqs = ["".join(rng.choice(list("ACGU"), int(rng.integers(N // 2 + 1, N))))
            for _ in range(B)]
    st_j = {k: np.asarray(v) for k, v in
            FJ.FoldEngine(jcfg, B).init_state(seqs, seqids=range(B)).items()}
    eng = FT.FoldEngine(tcfg, B, device="cpu")
    assert eng.integral == (weights == (3.0, 2.0, 1.0))
    st_t = state_from_numpy(st_j, "cpu")
    back = state_to_numpy(st_t)
    own = state_to_numpy(eng.init_state(seqs, seqids=list(range(B))))
    assert set(back) == set(st_j) | set(FT.PORT_KEYS) == set(own)
    for k, v in st_j.items():
        for other in (back, own):
            assert other[k].dtype == v.dtype and other[k].shape == v.shape, k
            np.testing.assert_array_equal(other[k], v, err_msg=k)
    assert st_t["pt"].shape == (B, K, N) and st_t["pt"].dtype == torch.int32
    assert st_t["seen_h1"].dtype == torch.int64
