"""The region-slot width R and its need, r_need, against the JAX engine
and the sequential CPU engine.

A fold's r_need is the most live regions that any new structure it
considered had; a structure with more than R drops regions, and the
engine flags the fold r_slots.  With R cut below the need of a seeded
sequence set, the port flags the lanes whose r_need is over R, and the
JAX engine flags the same lanes with the same state (the port's own keys
aside).  With R at the largest need reported there, no lane is flagged
and the beams are fold_cpu's; at every wider R the need and the beams
stay the same.  N=64 keeps the JAX compile short.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu_torch.convert import state_to_numpy
from rafft_tpu_torch.engine import fold_cpu
from rafft_tpu_torch.engine import fold_torch as FT

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

CUT = FT.EngineConfig(N=64, K=6, R=3, M=24, V=128, W=4, CPLX=64, S=1024,
                      max_branch=128, max_steps=8)


def _seqs():
    rng = np.random.default_rng(11)
    return ["".join(rng.choice(list("ACGU"), int(rng.integers(40, 64))))
            for _ in range(4)]


def _fold(R):
    eng = FT.FoldEngine(dataclasses.replace(CUT, R=R), B=4, device="cpu")
    beams, st = eng.run(_seqs())
    return beams, state_to_numpy(st), FT.FoldEngine.flags(st).numpy()


@pytest.fixture(scope="module")
def cut():
    return _fold(CUT.R)


def test_cut_slots_flag_r_slots_as_jax(cut):
    beams_t, st_t, flags = cut
    beams_j, st_j = FJ.FoldEngine(FJ.EngineConfig(**vars(CUT)), B=4).run(
        _seqs())
    st_j = {k: np.asarray(v) for k, v in st_j.items()}
    over = st_t["r_need"] > CUT.R
    assert over.any() and not over.all(), st_t["r_need"]
    np.testing.assert_array_equal((flags & FT.FLAG_RSLOTS) != 0, over)
    assert beams_t == beams_j
    assert st_t.keys() == st_j.keys() | set(FT.PORT_KEYS)
    for k in st_j:
        np.testing.assert_array_equal(st_t[k], st_j[k], err_msg=k)


def test_slots_at_the_need_fold_as_fold_cpu(cut):
    need = int(cut[1]["r_need"].max())
    beams, st, flags = _fold(need)
    assert not flags.any(), flags
    assert int(st["r_need"].max()) == need
    for seq, beam in zip(_seqs(), beams):
        want = fold_cpu.fold(seq, nb_mode=CUT.M, max_stack=CUT.K,
                             max_branch=CUT.max_branch)
        assert beam == [(s.str_struct, s.energy) for s in want]


@pytest.mark.parametrize("wider", [1, 8])
def test_slots_past_the_need_change_nothing(cut, wider):
    need = int(cut[1]["r_need"].max())
    beams, st, flags = _fold(need)
    beams_w, st_w, flags_w = _fold(need + wider)
    assert beams_w == beams and not flags_w.any()
    np.testing.assert_array_equal(st_w["r_need"], st["r_need"])
