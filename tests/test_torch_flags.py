"""Exactness flags of the PyTorch fold engine against the JAX engine.

Budgets cut far below the sweep's make the engines give up exactness on
purpose: a complex-candidate budget of CPLX=1 drops candidates
(cplx_dropped > 0, reported as FLAG_CPLX), and a seen-set of S=24 slots
overflows (FLAG_SEEN).  Both engines must agree on the final beams, the
flags and the whole final state, with one exception: once a lane's
seen-set overflows, the JAX engine sends every non-new slot's write to
slot S-1 as well (fold_jax.py:1238-1240), so that slot holds whichever
colliding update XLA applied last.  The slot is never read (membership
looks at slots below seen_cnt, which stops at S-1), so it is compared
only on lanes that did not overflow.  N=64 keeps the JAX compiles short.
"""

import numpy as np
import pytest
import torch

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu_torch.convert import state_to_numpy
from rafft_tpu_torch.engine import fold_torch as FT

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

STATE_KEYS = ("pt", "energy", "active", "rorder", "seen_cnt", "done",
              "cplx_dropped", "enum_suspect")
BASE = dict(N=64, K=6, R=8, M=24, V=128, W=4, CPLX=64, S=1024,
            max_branch=128, max_steps=8)


def _seqs():
    rng = np.random.default_rng(11)
    return ["".join(rng.choice(list("ACGU"), int(rng.integers(40, 64))))
            for _ in range(4)]


def _flags(st):
    return (st["enum_suspect"]
            | np.where(st["cplx_dropped"] > 0, FT.FLAG_CPLX, 0))


@pytest.mark.parametrize("cut, flag", [(dict(CPLX=1), FT.FLAG_CPLX),
                                       (dict(S=24), FT.FLAG_SEEN)])
def test_budget_flags_match_jax(cut, flag):
    cfg = dict(BASE, **cut)
    S = cfg["S"]
    seqs = _seqs()
    beams_j, st_j = FJ.FoldEngine(FJ.EngineConfig(**cfg), B=4).run(seqs)
    beams_t, st_t = FT.FoldEngine(FT.EngineConfig(**cfg), B=4,
                                  device="cpu").run(seqs)
    st_j = {k: np.asarray(v) for k, v in st_j.items()}
    st_t = state_to_numpy(st_t)
    flags = _flags(st_j)
    assert (flags & flag).any(), "the cut budget did not overflow"
    np.testing.assert_array_equal(_flags(st_t), flags)
    assert beams_t == beams_j
    for k in STATE_KEYS:
        np.testing.assert_array_equal(st_t[k], st_j[k], err_msg=k)
    overflowed = (flags & FT.FLAG_SEEN) != 0
    for k in ("seen_h1", "seen_h2"):
        np.testing.assert_array_equal(st_t[k][:, : S - 1],
                                      st_j[k][:, : S - 1], err_msg=k)
        np.testing.assert_array_equal(st_t[k][~overflowed],
                                      st_j[k][~overflowed], err_msg=k)
