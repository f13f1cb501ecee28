"""K=200 (-n 200 -ms 200, the reference's second configuration) on the CPU.

One sequence of 60 nt at N=64 fills a beam of 200: the port's engine on
the CPU against the JAX engine on the CPU (state, beam and flags equal:
integral weights, so both sides are exact) and against the sequential
parity engine.  The full-width K=200 configurations (3,200 beam rows at
the 128 bucket) run on the card in chip_smoke.py.
"""

import numpy as np
import torch

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu_torch.convert import state_to_numpy
from rafft_tpu_torch.engine import fold_cpu
from rafft_tpu_torch.engine import fold_torch as FT

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

CFG = dict(N=64, K=200, R=8, M=48, V=512, CPLX=512, S=6400, max_branch=400,
           max_steps=12)
STEP_KEYS = ("pt", "energy", "active", "rorder", "seen_h1", "seen_h2",
             "seen_cnt", "done", "cplx_dropped", "enum_suspect")


def test_k200_fold_matches_jax_and_fold_cpu():
    rng = np.random.default_rng(200)
    seq = "".join(rng.choice(list("ACGU"), 60))
    beams_j, st_j = FJ.FoldEngine(FJ.EngineConfig(**CFG), B=1).run([seq])
    beams_t, st_t = FT.FoldEngine(FT.EngineConfig(**CFG), B=1,
                                  device="cpu").run([seq])
    assert beams_t == beams_j and len(beams_t[0]) > 150
    st_j = {k: np.asarray(v) for k, v in st_j.items()}
    st_t = state_to_numpy(st_t)
    for k in STEP_KEYS:
        assert st_t[k].dtype == st_j[k].dtype, k
        np.testing.assert_array_equal(st_t[k], st_j[k], err_msg=k)
    assert not st_t["enum_suspect"].any() and not st_t["cplx_dropped"].any()
    want = [(s.str_struct, s.energy)
            for s in fold_cpu.fold(seq, nb_mode=48, max_stack=200,
                                   max_branch=400)]
    assert beams_t[0] == want


def test_the_budget_rule_resolves_a_fold_the_base_budget_flags():
    """A K=200 fold whose steps offer more complex candidates than a
    base budget of 32 holds: at 32 the port flags it (cplx_budget); at
    cplx_budget(32, 200) = 128, the rule's budget, it is unflagged and
    every row and its energy equal the benchmark's plain reference."""
    from perfbench.reference.fold import fold as reference_fold
    rng = np.random.default_rng(200)
    seq = "".join(rng.choice(list("ACGU"), 60))
    base = 32
    flags, needs, beams = {}, {}, {}
    for cplx in (base, FT.cplx_budget(base, 200)):
        eng = FT.FoldEngine(FT.EngineConfig(**dict(CFG, CPLX=cplx)), B=1,
                            device="cpu")
        (beams[cplx],), st = eng.run([seq])
        flags[cplx] = int(eng.flags(st)[0])
        needs[cplx] = int(st["cplx_need"][0])
    assert flags == {32: FT.FLAG_CPLX, 128: 0}
    assert base < needs[128] <= 128
    want = [(s.str_struct, s.energy) for s in reference_fold(
        seq, nb_mode=48, max_stack=200, max_branch=400)]
    assert beams[128] == want and len(want) > 150
