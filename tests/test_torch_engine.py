"""The PyTorch fold engine against the JAX engine and the CPU oracle.

Configurations are those of tests/test_jax_engine.py.  On the CPU the
JAX engine runs _correlate + _window_scan and the torch engine runs the
plain wavefront; both are exact for integral weights, so states, beams
and flags must be equal, not close.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu.engine.fold_cpu import fold as cpu_fold
from rafft_tpu_torch.convert import state_from_numpy, state_to_numpy
from rafft_tpu_torch.engine import fold_torch as FT

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

STEP_KEYS = ("pt", "energy", "active", "rorder", "seen_h1", "seen_h2",
             "seen_cnt", "done", "cplx_dropped", "enum_suspect")
HASH_CFG = dict(N=64, K=8, R=8, M=32, V=256, CPLX=64, S=1024,
                max_branch=256, max_steps=10)


def _hash_seqs():
    rng = np.random.default_rng(3)
    return ["".join(rng.choice(list("ACGU"), int(rng.integers(24, 60))))
            for _ in range(4)]


@pytest.fixture(scope="module")
def jax_hash_engine():
    return FJ.FoldEngine(FJ.EngineConfig(**HASH_CFG), B=4)


def _np_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


def test_config_and_flags_mirror_jax():
    jf = {f.name: f.default for f in dataclasses.fields(FJ.EngineConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(FT.EngineConfig)}
    assert jf == tf
    for name in ("FLAG_VWINDOW", "FLAG_RSLOTS", "FLAG_SEEN", "FLAG_HASH",
                 "FLAG_CPLX", "FLAG_STEPLIM"):
        assert getattr(FJ, name) == getattr(FT, name), name
    assert np.float32(FJ.NEG) == np.float32(FT.NEG)


def test_one_step_from_jax_state(jax_hash_engine):
    """Two JAX steps, then one step in each engine from the same state."""
    ej = jax_hash_engine
    et = FT.FoldEngine(FT.EngineConfig(**HASH_CFG), B=4, device="cpu")
    st = ej.init_state(_hash_seqs())
    for _ in range(2):
        st = ej._step(st)
    want = _np_state(ej._step(st))
    got = state_to_numpy(et.step(state_from_numpy(_np_state(st), "cpu")))
    assert not want["done"].all()
    for k in STEP_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_hash_config_whole_fold_matches_jax(jax_hash_engine):
    """Final beams and states (seen-set included) equal the JAX engine's:
    the composed incremental hashes are right wherever they were used."""
    seqs = _hash_seqs()
    beams_j, _, st_j = jax_hash_engine.run(seqs, collect_traj=True)
    et = FT.FoldEngine(FT.EngineConfig(**HASH_CFG), B=4, device="cpu")
    beams_t, st_t = et.run(seqs)
    assert beams_t == beams_j
    st_j, st_t = _np_state(st_j), state_to_numpy(st_t)
    for k in STEP_KEYS:
        np.testing.assert_array_equal(st_t[k], st_j[k], err_msg=k)
    assert (st_t["seen_cnt"] > 0).all() and not st_t["enum_suspect"].any()


def test_tiny_fold_matches_cpu():
    cfg = FT.EngineConfig(N=32, K=2, R=4, M=8, V=16, CPLX=8, S=64,
                          max_branch=16, max_steps=6)
    seqs = ["GGGAAACCCAAAGGGAAACCC", "GCGCUUCGGCGCGC"]
    beams, _ = FT.FoldEngine(cfg, B=2, device="cpu").run(seqs)
    for seq, rows in zip(seqs, beams):
        want = [(s.str_struct, s.energy)
                for s in cpu_fold(seq, nb_mode=8, max_stack=2, max_branch=16)]
        assert rows == want, seq


def test_region_overflow_flagged():
    seq = "GGGGAAAACCCCAAGGGGAAAACCCCAAGGGGAAAACCCC"
    kw = dict(N=64, K=4, M=16, V=64, CPLX=16, S=256, max_branch=64,
              max_steps=8)
    _, st = FT.FoldEngine(FT.EngineConfig(R=2, **kw), B=1, device="cpu").run([seq])
    assert int(st["enum_suspect"][0]) & FT.FLAG_RSLOTS
    beams, st2 = FT.FoldEngine(FT.EngineConfig(R=8, **kw), B=1,
                               device="cpu").run([seq])
    assert int(st2["enum_suspect"][0]) == 0
    want = [(s.str_struct, s.energy)
            for s in cpu_fold(seq, nb_mode=16, max_stack=4, max_branch=64)]
    assert beams[0] == want


def test_non_integral_weights_refused():
    """Non-integral pair weights were refused before the FFT correlation
    was ported; the same constructor call now gives an engine that folds
    to the CPU oracle's beam (tests/test_torch_weights.py holds the path
    against the JAX engine)."""
    cfg = FT.EngineConfig(N=32, K=2, M=8, gc_wei=2.5)
    eng = FT.FoldEngine(cfg, B=1, device="cpu")
    assert not eng.integral
    seq = "GGGAAACCCAAAGGGAAACCC"
    beams, _ = eng.run([seq])
    want = [(s.str_struct, s.energy)
            for s in cpu_fold(seq, nb_mode=8, max_stack=2, max_branch=1000,
                              gc_wei=2.5)]
    assert beams[0] == want and want[0][1] < 0


@pytest.mark.parametrize("n", [1025, 4096])
def test_long_sequences_refused(n):
    """Sequences past 1024 nt were refused before the 2048/4096 buckets
    were ported; now fold_one's engine for them is built (N = 2048 and
    4096, R = 32) and holds the sequence.  The fold itself takes minutes
    on the CPU at these sizes: tests/test_torch_long2048.py folds a cut
    configuration, chip_smoke.py the full ones on the card.  Past 4096
    the engine refuses with a ValueError."""
    seq = "GC" * (n // 2) + "A" * (n % 2)
    N = 1 << int(np.ceil(np.log2(n)))
    assert N == (2048 if n == 1025 else 4096) and N <= FT.MAX_N
    cfg = FT.EngineConfig(N=N, K=2, M=10, R=32)
    eng = FT.FoldEngine(cfg, B=1, device="cpu")
    st = eng.init_state([seq])
    assert int(st["n"][0]) == n and st["pt"].shape == (1, 2, N)
    assert eng.Z1.shape == (N + 1,) and eng.wtabs.SE.shape == (625,)
    assert bool(st["active"][0, 0]) and not bool(st["done"][0])
    with pytest.raises(ValueError, match="4096"):
        FT.FoldEngine(FT.EngineConfig(N=8192, K=2, M=10), B=1, device="cpu")
