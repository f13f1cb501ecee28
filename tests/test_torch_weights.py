"""Non-integral pair weights: the port's FFT correlation path on the CPU.

With non-integral weights the lags of a region are ranked by the FFT
correlation (fold_torch._correlate against fold_jax._correlate), and the
window-slide values come from the wavefront tables gathered at the
chosen lags (against fold_jax._window_scan, which the JAX engine runs on
the CPU).

Tolerances.  The window-slide values are a sequential float32 recurrence
per lag, the same operations in the same order on both sides: exact.
The FFT correlation sums carry float32 noise that differs between
torch's and XLA's transforms: COR_TOL absolute on the normalised
correlation (values up to about 3).  Lags whose pair content is the same
tie up to that noise, and lag order feeds the candidate order, so a step
may differ legitimately: the rule (`_same_or_tie`) is that the states
are equal, or the two engines' lag ranks differ at that step and every
differing rank swaps two lags whose correlations differ by less than
COR_TOL.  Anything else is a fault.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rafft_tpu.energy.eval_jax import device_params as jax_device_params
from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu_torch.convert import state_from_numpy, state_to_numpy
from rafft_tpu_torch.energy.eval_torch import analyze_pt, device_params, take
from rafft_tpu_torch.engine import fold_torch as FT
from rafft_tpu_torch.engine import wavefront as WT
from rafft_tpu_torch.scan.encode import weight_matrix

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

COR_TOL = 2e-5
WEIGHTS = dict(gc_wei=2.5, au_wei=1.7, gu_wei=0.8)
STEP_KEYS = ("pt", "energy", "active", "rorder", "seen_h1", "seen_h2",
             "seen_cnt", "done", "cplx_dropped", "enum_suspect")
FOLD_CFG = dict(N=48, K=6, R=8, M=24, V=128, CPLX=32, S=512, max_branch=128,
                max_steps=10, **WEIGHTS)


def _layout(rng, K, R, N):
    """Engine-valid regions: rcodes, rpos, mlen [K, R, ...] and codes."""
    rpos = np.full((K, R, N), N, np.int32)
    rcodes = np.zeros((K, R, N), np.int32)
    mlen = np.zeros((K, R), np.int32)
    for k in range(K):
        n = int(rng.integers(N // 2, N + 1))
        codes = rng.integers(1, 5, n)
        keep = np.nonzero(rng.random(n) < rng.uniform(0.4, 1.0))[0]
        nreg = int(rng.integers(1, R + 1))
        slot = rng.integers(0, nreg, len(keep))
        if k == 0:
            keep, slot = np.arange(n), np.zeros(n, np.int64)
        for r in range(nreg):
            pos = keep[slot == r]
            rpos[k, r, : len(pos)] = pos
            rcodes[k, r, : len(pos)] = codes[pos]
            mlen[k, r] = len(pos)
    return rcodes, rpos, mlen


@pytest.mark.parametrize("weights,integral", [((3.0, 2.0, 1.0), True),
                                              ((2.5, 1.7, 0.8), False),
                                              ((3.0, 2.0, 1.0), False)])
def test_correlate_matches_jax(weights, integral):
    """Integral: equal after rounding.  Unrounded: within COR_TOL."""
    K, R, N = 5, 6, 64
    rcodes, _, mlen = _layout(np.random.default_rng(11), K, R, N)
    cfg = FT.EngineConfig(N=N, K=K, R=R, M=16)
    W = weight_matrix(*weights)
    want = np.asarray(FJ._correlate(FJ.EngineConfig(N=N, K=K, R=R, M=16), W,
                                    jnp.asarray(rcodes), jnp.asarray(mlen),
                                    integral))
    got = FT._correlate(cfg, W, torch.as_tensor(rcodes)[None],
                        torch.as_tensor(mlen)[None], integral)[0]
    assert got.dtype == torch.float32 and got.shape == (K, R, 2 * N - 1)
    got = got.numpy()
    valid = np.arange(2 * N - 1) < 2 * mlen[..., None] - 1
    assert (got[~valid] == np.float32(FT.NEG)).all()
    assert (want[~valid] == np.float32(FJ.NEG)).all()
    if integral:
        np.testing.assert_array_equal(got, want)
    else:
        err = np.abs(got[valid] - want[valid]).max()
        assert 0 <= err < COR_TOL, err
        # and against the exact sums along the diagonals (float64)
        exact = np.zeros((K, R, 2 * N - 1))
        for k in range(K):
            for r in range(R):
                c = rcodes[k, r, : mlen[k, r]]
                pw = W[c[:, None], c[None, :]]
                for lag in range(2 * len(c) - 1):
                    exact[k, r, lag] = np.trace(pw[:, ::-1],
                                                len(c) - 1 - lag)
        m = mlen[..., None]
        lag = np.arange(2 * N - 1)
        norm = np.minimum(lag, np.maximum(2 * m - 2 - lag, 0)) + 1.0
        assert np.abs(got[valid] - (exact / norm)[valid]).max() < COR_TOL


def test_window_tables_equal_window_scan_at_selected_lags():
    """The six integer tables of the wavefront plain version, gathered at
    the lags the FFT correlation selects, equal fold_jax._window_scan
    entry for entry at non-integral weights, wherever the lag is usable
    (_window_scan leaves the rest at 0 and the step masks them).  Where
    no run was found (max_nb == 0 on both sides) the tables' max_i and
    max_j keep what the padding cells of the diagonal left there, as the
    Pallas kernel's do, and _window_scan has 0: the step reads neither
    (`has = max_nb > 0`)."""
    K, R, N, M = 6, 6, 64, 40
    rng = np.random.default_rng(12)
    rcodes, rpos, mlen = _layout(rng, K, R, N)
    W = weight_matrix(2.5, 1.7, 0.8)
    z = rng.integers(1, 2**32 - 1, (2, N + 1), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    z1row, z2row = z[0][np.clip(rpos, 0, N)], z[1][np.clip(rpos, 0, N)]
    jcfg = FJ.EngineConfig(N=N, K=K, R=R, M=M)
    cor = FJ._correlate(jcfg, W, jnp.asarray(rcodes), jnp.asarray(mlen), False)
    lags, lvals = FJ._top_lags(jcfg, cor)
    lag_ok = (lvals > FJ.NEG / 2) & (jnp.asarray(mlen)[:, :, None] >= 2)
    want = FJ._window_scan(jcfg, jax_device_params(37.0, max_len=N), W,
                           jnp.asarray(rcodes), jnp.asarray(rpos),
                           jnp.asarray(mlen), lags, lag_ok,
                           z1row=jnp.asarray(z1row), z2row=jnp.asarray(z2row))
    tcfg = FT.EngineConfig(N=N, K=K, R=R, M=M)
    tabs = WT.wavefront_tables_ref(
        tcfg, WT.small_tables(device_params(37.0, N, "cpu"), W, "cpu"),
        *(torch.as_tensor(x) for x in (rcodes, rpos, mlen, z1row, z2row)))
    ok = np.asarray(lag_ok)
    li = torch.as_tensor(np.array(lags)).long()
    assert ok.sum() > 200 and (np.asarray(want["max_nb"])[ok] > 1).sum() > 50
    found = ok & (np.asarray(want["max_nb"]) > 0)
    for tk, jk in (("max_nb", "max_nb"), ("max_i", "max_i"),
                   ("max_j", "max_j"), ("best_sE", "best_sE"),
                   ("hd1", "best_h1"), ("hd2", "best_h2")):
        got = tabs[tk].gather(-1, li).numpy()
        at = ok if tk not in ("max_i", "max_j") else found
        np.testing.assert_array_equal(got[at], np.asarray(want[jk])[at],
                                      err_msg=tk)


# ----------------------------------------------------------------------
# engine steps and folds under the tie rule
# ----------------------------------------------------------------------

def _np_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _lag_ranks(ej, et, st_np):
    """Both engines' lag ranks for the regions of one state: (lags of the
    JAX engine, lags of the port, the JAX correlation), [B,K,R,...]."""
    cfg = et.cfg
    st = state_from_numpy(st_np, "cpu")
    B, K, N = et.B, cfg.K, cfg.N
    loops = analyze_pt(et.dp, st["codes"][:, None].expand(B, K, N), st["pt"],
                       st["n"][:, None].expand(B, K))
    rpos, _, _, mlen = FT._regions(cfg, st["pt"], loops["enclose"],
                                   st["rorder"], st["n"])
    rcodes = torch.where(rpos < N, take(st["codes"], rpos.clamp(0, N - 1)), 0)
    cor_t = FT._correlate(cfg, et.W, rcodes, mlen, False)
    lags_t, _ = FT._top_lags(cfg, cor_t)
    cor_j = jax.vmap(lambda c, m: FJ._correlate(ej.cfg, ej.W, c, m, False))(
        jnp.asarray(rcodes.numpy()), jnp.asarray(mlen.numpy()))
    lags_j, _ = FJ._top_lags(ej.cfg, cor_j)
    return np.asarray(lags_j), lags_t.numpy(), np.asarray(cor_j)


def _ranks_differ_by_ties(lags_j, lags_t, cor_j):
    """Number of ranks at which the two lag orders differ; raises unless
    there is one and each swaps lags within COR_TOL of each other."""
    swapped = lags_j != lags_t
    assert swapped.any(), "the steps differ although the lag ranks agree"
    a = np.take_along_axis(cor_j, lags_j, -1)[swapped]
    b = np.take_along_axis(cor_j, lags_t, -1)[swapped]
    gap = np.abs(a - b).max()
    assert gap < COR_TOL, f"lag ranks differ by {gap}, not by a tie"
    return int(swapped.sum())


def _same_or_tie(ej, et, st_np, want, got):
    """The rule of the module note.  Returns 0 when the two step results
    are equal, else the number of lag ranks that differ by a tie."""
    if all(np.array_equal(got[k], want[k]) for k in STEP_KEYS):
        return 0
    return _ranks_differ_by_ties(*_lag_ranks(ej, et, st_np))


def _seqs(seed, count, lo, hi):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGU"), int(rng.integers(lo, hi))))
            for _ in range(count)]


@pytest.fixture(scope="module")
def engines():
    return (FJ.FoldEngine(FJ.EngineConfig(**FOLD_CFG), B=4),
            FT.FoldEngine(FT.EngineConfig(**FOLD_CFG), B=4, device="cpu"))


def _lockstep(ej, et, seqs):
    """Step both engines from the JAX engine's state, every step of the
    fold.  Returns (steps compared, ranks that differed by ties)."""
    st = ej.init_state(seqs)
    steps = ties = 0
    while not bool(np.asarray(st["done"]).all()) and steps < ej.cfg.max_steps:
        st_np = _np_state(st)
        nxt = ej._step(st)
        got = state_to_numpy(et.step(state_from_numpy(st_np, "cpu")))
        want = _np_state(nxt)
        for k in STEP_KEYS:
            assert got[k].dtype == want[k].dtype, k
        ties += _same_or_tie(ej, et, st_np, want, got)
        st, steps = nxt, steps + 1
    return steps, ties


def test_steps_match_jax_at_non_integral_weights(engines):
    """Every step of a fold of random sequences, each from the JAX
    engine's own state: equal, or a tie of the FFT correlation."""
    ej, et = engines
    assert not ej.integral and not et.integral and not ej.use_wavefront
    steps, ties = _lockstep(ej, et, _seqs(5, 4, 30, 48))
    assert steps >= 3
    print(f"{steps} steps compared, {ties} lag ranks differed by ties")


def test_repetitive_sequences_under_the_tie_rule(engines):
    """Repeats make lags of equal pair content: where the FFT noise of
    the two transforms orders them differently the rule must explain
    it."""
    ej, et = engines
    seqs = ["GCAU" * 11, "GGGAAACCCUUU" * 3 + "GGGAAACC", "GU" * 20,
            "ACGUUGCA" * 5]
    steps, ties = _lockstep(ej, et, seqs)
    assert steps >= 2
    print(f"{steps} steps compared, {ties} lag ranks differed by ties")


def test_whole_fold_matches_jax_at_non_integral_weights(engines):
    ej, et = engines
    seqs = _seqs(6, 4, 32, 48)
    beams_j, traj_j, st_j = ej.run(seqs, collect_traj=True)
    beams_t, traj_t, st_t = et.run(seqs, collect_traj=True)
    if beams_t != beams_j or traj_t != traj_j:
        # a legitimate difference starts at a step that _lockstep explains
        steps, ties = _lockstep(ej, et, seqs)
        assert ties > 0, "the folds differ and no step differs by a tie"
    else:
        st_j, st_t = _np_state(st_j), state_to_numpy(st_t)
        for k in STEP_KEYS:
            np.testing.assert_array_equal(st_t[k], st_j[k], err_msg=k)
    assert all(rows and rows[0][1] < 0 for rows in beams_t)


def test_tie_rule_rejects_a_real_difference(engines):
    """The rule is not a free pass: a step result that differs while the
    lag ranks agree, and a rank swap beyond COR_TOL, are both faults."""
    ej, et = engines
    st = ej.init_state(_seqs(5, 4, 30, 48))
    st_np = _np_state(st)
    want = _np_state(ej._step(st))
    got = {k: v.copy() for k, v in want.items()}
    assert _same_or_tie(ej, et, st_np, want, got) == 0
    got["energy"][0, 0] -= 1
    lags_j, lags_t, cor_j = _lag_ranks(ej, et, st_np)
    if np.array_equal(lags_j, lags_t):
        with pytest.raises(AssertionError, match="lag ranks agree"):
            _same_or_tie(ej, et, st_np, want, got)
    # two lags swapped: a tie passes, a real gap does not
    cor = np.zeros((1, 1, 1, 2 * et.cfg.N - 1), np.float32)
    cor[..., 3], cor[..., 7], cor[..., 9] = 2.0, 2.0 + COR_TOL / 4, 1.5
    rank = lambda *lags: np.array(lags).reshape(1, 1, 1, -1)
    assert _ranks_differ_by_ties(rank(7, 3, 9), rank(3, 7, 9), cor) == 2
    with pytest.raises(AssertionError, match="not by a tie"):
        _ranks_differ_by_ties(rank(7, 3, 9), rank(7, 9, 3), cor)
