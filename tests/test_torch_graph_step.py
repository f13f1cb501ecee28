"""The fold step with no host read, against the JAX engine, step by step.

FoldEngine.step evaluates the complex candidates at the fixed width CPLX
and runs all W enumeration windows, and _advance runs its G rounds with
no early exit, so every shape of a step is fixed by the configuration
(what a CUDA graph capture needs).  On the CPU the eager step must still
equal the JAX CPU engine after every step, in every lane: at N=32 and
64, at K=50 and K=200, with a row that goes dead mid-run and with a row
whose seen set overflows.  Integral weights, so states are equal, not
close.  Under FLAG_SEEN the never-read slot S-1 of an overflowed lane is
left out, as tests/test_torch_flags.py explains.

tests/test_torch_graph_cuda.py holds the graphed path to this eager one
on a card.
"""

import functools

import numpy as np
import pytest
import torch

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu_torch.convert import state_to_numpy
from rafft_tpu_torch.engine import fold_torch as FT
from tests.test_torch_graph_cuda import CASES, CFG32, _random

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

STEP_KEYS = ("pt", "energy", "active", "rorder", "seen_h1", "seen_h2",
             "seen_cnt", "done", "cplx_dropped", "enum_suspect")


@functools.lru_cache(maxsize=None)
def _jax_engine(items, B):
    return FJ.FoldEngine(FJ.EngineConfig(**dict(items)), B=B)


def _equal_states(got, want, S, what):
    overflowed = (want["enum_suspect"] & FT.FLAG_SEEN) != 0
    for k in STEP_KEYS:
        g, w = got[k], want[k]
        if k in ("seen_h1", "seen_h2"):
            # slot S-1 of an overflowed lane is never read (module note)
            g, w = g.copy(), w.copy()
            g[overflowed, S - 1] = w[overflowed, S - 1] = 0
        assert g.dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_eager_steps_match_jax(case):
    cfg, seqs, shows = CASES[case]
    B = len(seqs)
    ej = _jax_engine(tuple(sorted(cfg.items())), B)
    et = FT.FoldEngine(FT.EngineConfig(**cfg), B=B, device="cpu")
    assert not et.graphs
    st_j, st_t = ej.init_state(seqs), et.init_state(seqs)
    done_at = []
    for step in range(cfg["max_steps"]):
        st_j = ej._step(st_j)
        st_t = et.step(st_t)
        want = {k: np.asarray(v) for k, v in st_j.items()}
        _equal_states(state_to_numpy(st_t), want, cfg["S"],
                      f"{case} step {step}")
        done_at.append(want["done"].copy())
        if want["done"].all():
            break
    done_at = np.array(done_at)
    # (once its seen set overflows, dedup is void and a lane may cycle)
    assert done_at[-1].all() or shows == "overflow", \
        "the fold did not finish within max_steps"
    if shows == "dead":
        assert done_at[0, 0] and not done_at[0, 1:].any()
    if shows == "overflow":
        bits = want["enum_suspect"] & FT.FLAG_SEEN
        assert bits[1] and not bits[0], "the seen set did not overflow on " \
                                        "the long row alone"


def test_idle_windows_leave_state_unchanged():
    """A step with twice the windows equals the step with W windows where
    no lane ran out of windows: a window with no lane to run is a no-op
    on the seen set, the top-K and the flags, bit for bit."""
    seqs = _random(7, 3, 20, 33)
    states = []
    for W in (CFG32["W"], 2 * CFG32["W"]):
        et = FT.FoldEngine(FT.EngineConfig(**dict(CFG32, W=W)), B=3,
                           device="cpu")
        st, seq_states = et.init_state(seqs), []
        for _ in range(CFG32["max_steps"]):
            st = et.step(st)
            seq_states.append(state_to_numpy(st))
        states.append(seq_states)
    for step, (a, b) in enumerate(zip(*states)):
        assert not (a["enum_suspect"] & FT.FLAG_VWINDOW).any()
        for k in STEP_KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{step}: {k}")


def test_advance_rounds_match_jax():
    """_advance, G=3 rounds at a time and no host read inside, against
    the JAX engine's _advance, every key of the state after every call:
    lanes swap onto shadow sequences, bank their results, stop at the
    step limit (max_steps=3, so 6 steps), and once no lane is runnable
    the rounds leave the state as it was."""
    cfg = dict(CFG32, max_steps=3)
    seqs = _random(9, 5, 16, 33)
    B = 2
    ej = FJ.FoldEngine(FJ.EngineConfig(**cfg), B=B)
    et = FT.FoldEngine(FT.EngineConfig(**cfg), B=B, device="cpu")
    st_j = ej.init_state(seqs[:B], seqids=[0, 1])
    st_t = et.init_state(seqs[:B], seqids=[0, 1])
    codes, n = et._encode(seqs[B:2 * B], B)
    load = (np.zeros(B, bool), np.ones(B, bool), codes, n,
            np.array([2, 3], np.int32))
    st_j = ej._drain_load(st_j, *load)
    st_t = et._drain_load(st_t, *(torch.as_tensor(x) for x in load))
    last = None
    for call in range(6):
        st_j = ej._advance(st_j, 3)
        st_t = et._advance(st_t, 3)
        want = {k: np.asarray(v) for k, v in st_j.items()}
        got = state_to_numpy(st_t)
        assert got.keys() == want.keys() | set(FT.PORT_KEYS)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"call {call}: {k}")
        # the port's own keys: counts of complex candidates and of live
        # regions, never more than a step offers
        for k in FT.PORT_KEYS:
            assert (0 <= got[k]).all() and (
                got[k] <= cfg["K"] * cfg["R"] * cfg["M"]).all(), k
        last = want
    # nothing was drained, so every lane banked one fold and stopped
    assert last["out_valid"].all() and not last["next_avail"].any()
    assert (last["lane_steps"] <= 2 * cfg["max_steps"]).all()
