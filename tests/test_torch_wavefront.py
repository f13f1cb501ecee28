"""The PyTorch wavefront window scan against the Pallas kernel.

wavefront_tables_ref (rafft_tpu_torch) must reproduce the Pallas kernel
(rafft_tpu.engine.wavefront, run through the Pallas interpreter as
tests/test_wavefront.py runs it) entry for entry over whole [K, R, 2N]
tables, padding cells and zeroed tail included.  All tables are exact
(integers, and f32 sums of small integers), so comparisons are exact.
wavefront_tables_closed, the plain twin of the CUDA kernel's algorithm
(region cells only, closed forms for the padding entries), is held
against wavefront_tables_ref here on the CPU; the CUDA kernel itself is
held against wavefront_tables_ref on the card.
"""

import numpy as np
import pytest
import torch

from rafft_tpu.engine.wavefront import wavefront_tables as pallas_tables
from rafft_tpu_torch.energy.eval_torch import device_params
from rafft_tpu_torch.engine import fold_torch as FT
from rafft_tpu_torch.engine import wavefront as WT
from tests.test_wavefront import CFG, DP, W, _Z1, _random_regions, _zrows

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

DPT = device_params(37.0, CFG.N, "cpu")


def _degenerate():
    """Empty regions, single positions, a full contiguous region, and a
    beam row whose regions are all empty (mlen 0)."""
    K, R, N = CFG.K, CFG.R, CFG.N
    rpos = np.full((K, R, N), N, dtype=np.int32)
    rcodes = np.zeros((K, R, N), dtype=np.int32)
    mlen = np.zeros((K, R), dtype=np.int32)
    codes = np.random.default_rng(7).integers(0, 4, size=80)
    rpos[0, 0, :80] = np.arange(80)
    rcodes[0, 0, :80] = codes
    mlen[0, 0] = 80
    rpos[0, 1, 0] = 5
    rcodes[0, 1, 0] = 2
    mlen[0, 1] = 1
    rpos[0, 2, :2] = [10, 11]
    rcodes[0, 2, :2] = [1, 2]
    mlen[0, 2] = 2
    return rcodes, rpos, mlen          # beam row 1: every region empty


def _edges():
    """Whole-sequence regions (m = N, and m = N - 1 ending at N - 1),
    one-position regions at both ends of the sequence, positions inside
    the last min_hp of the sequence, and an empty beam row."""
    K, R, N = CFG.K, CFG.R, CFG.N
    rpos = np.full((K, R, N), N, dtype=np.int32)
    rcodes = np.zeros((K, R, N), dtype=np.int32)
    mlen = np.zeros((K, R), dtype=np.int32)
    codes = np.random.default_rng(11).integers(1, 5, size=N)

    def put(k, r, pos):
        pos = np.asarray(pos)
        rpos[k, r, :len(pos)] = pos
        rcodes[k, r, :len(pos)] = codes[pos]
        mlen[k, r] = len(pos)

    put(0, 0, np.arange(N))                 # the whole sequence
    put(0, 1, [N - 1])                      # one position, the last
    put(0, 2, [0])                          # one position, the first
    put(0, 3, np.arange(N - 6, N))          # all inside the last min_hp + 3
    put(1, 0, np.arange(1, N))              # m = N - 1
    put(1, 2, [3, 4, 5, N - 3, N - 2])      # slot 1 stays empty
    return rcodes, rpos, mlen


def _layout(case):
    if case == "degenerate":
        rc, rp, ml = _degenerate()
    elif case == "edges":
        rc, rp, ml = _edges()
    else:
        rc, rp, ml = (np.asarray(x) for x in
                      _random_regions(np.random.default_rng(int(case[-1]))))
    z1, z2 = (np.asarray(z) for z in _zrows(rp))
    return rc, rp, ml, z1, z2


def _port(arrays, fn=WT.wavefront_tables, device="cpu", cfg=CFG):
    t = [torch.as_tensor(np.array(x), device=device) for x in arrays]
    tabs = WT.small_tables(device_params(37.0, CFG.N, device), W, device)
    return fn(cfg, tabs, *t)


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "degenerate"])
def test_ref_matches_pallas_whole_tables(case):
    rc, rp, ml, z1, z2 = _layout(case)
    want = pallas_tables(CFG, DP, W, rc, rp, ml, z1row=z1, z2row=z2,
                         interpret=True)
    launches = WT.LAUNCHES
    got = _port((rc, rp, ml, z1, z2))
    assert WT.LAUNCHES == launches       # CPU tensors take the plain version
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == (torch.float32 if k == "cor_raw" else torch.int32)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    if case == "degenerate":
        assert not got["max_nb"][1].any() and not got["cor_raw"][1].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_ref_hash_deltas_brute_force(seed):
    """hd1 at every populated lag equals the sum over the winning stem's
    pairs of Z1[p5](p3+1) + Z1[p3](p5+1) mod 2^32."""
    rc, rp, ml, z1, z2 = _layout(f"seed{seed}")
    tabs = _port((rc, rp, ml, z1, z2))
    nb, mi, mj = (tabs[k].numpy() for k in ("max_nb", "max_i", "max_j"))
    hd1 = tabs["hd1"].numpy().astype(np.uint32)
    kk, rr, ll = np.nonzero(nb > 0)
    assert len(kk) > 50
    for k, r, lag in list(zip(kk, rr, ll))[::max(1, len(kk) // 60)]:
        acc = 0
        for t in range(nb[k, r, lag]):
            p5 = int(rp[k, r, mi[k, r, lag] - t])
            p3 = int(rp[k, r, mj[k, r, lag] + t])
            acc = (acc + int(_Z1[p5]) * (p3 + 1)
                   + int(_Z1[p3]) * (p5 + 1)) & 0xFFFFFFFF
        assert acc == int(hd1[k, r, lag]), (k, r, lag)


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "degenerate",
                                  "edges"])
@pytest.mark.parametrize("min_hp", [3, 0, 7])
def test_closed_form_twin_matches_ref(case, min_hp):
    """The kernel's algorithm (region cells only, closed-form padding
    entries, balanced lanes, half-window cut) gives the step-by-step
    tables, whole tables, on random, empty, one-position and
    whole-sequence layouts."""
    import dataclasses
    cfg = dataclasses.replace(CFG, min_hp=min_hp)
    arrays = _layout(case)
    want = _port(arrays, fn=WT.wavefront_tables_ref, cfg=cfg)
    got = _port(arrays, fn=WT.wavefront_tables_closed, cfg=cfg)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k]), k


def test_wavefront_work_hand_counted():
    """Regions of 0, 1, 2 and 3 positions at N = 8.  Diagonal lengths:
    m=1: 1; m=2: 1,2,1; m=3: 1,2,3,2,1.  A diagonal of len cells keeps
    the window over ceil(len/2): 1; 1+1+1; 1+1+2+1+1."""
    w = WT.wavefront_work(torch.tensor([[0, 1], [2, 3]], dtype=torch.int32), 8)
    assert w["regions"] == 4
    assert w["cells"] == 0 + 1 + 4 + 9
    assert w["window_cells"] == 0 + 1 + 3 + 6
    assert w["cor_cells"] == 0 + 0 + 1 + 3
    assert w["pad_lags"] == 16 + 15 + 13 + 11
    # needed inputs: the length and the m real entries of four rows per
    # region, the 25 weights and 625 stack energies; outputs 7 x 2N
    assert w["positions"] == 6
    assert w["bytes"] == (4 * 6 + 4 + 4 * 7 * 16 + 25 + 625) * 4
    assert w["int_ops"] == 10 * 60 + 4 * 5 + 55 * 6
    assert w["f32_ops"] == 10 * 6 + 4 * 1
    # an empty call and a full region
    assert WT.wavefront_work(np.zeros((0,), np.int32), 8)["bytes"] == 2600
    full = WT.wavefront_work(np.array([8]), 8)
    assert full["bytes"] == (4 * 8 + 1 + 7 * 16 + 650) * 4
    assert full["cells"] == 64 and full["pad_lags"] == 1
    assert full["window_cells"] == 20 + 16


def test_small_tables_built_once_per_engine(monkeypatch):
    """The lookup tables are uploaded when the engine is made, never in
    the fold step."""
    calls = []
    real = FT.small_tables

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(FT, "small_tables", counting)
    eng = FT.FoldEngine(FT.EngineConfig(N=32, K=4, R=4, M=16, V=64, CPLX=16,
                                        S=256, max_branch=32), B=2,
                        device="cpu")
    assert len(calls) == 1
    tabs = eng.wtabs
    assert tabs.W.dtype == torch.float32 and tabs.W.shape == (25,)
    assert tabs.PT.shape == (25,) and tabs.ST.shape == (64,)
    assert not (tabs.PT == 0).any()          # no pair reads as 7
    assert tabs.SE.shape == (625,)
    for la, lb in ((0, 0), (1 * 5 + 4, 3 * 5 + 2), (2 * 5 + 3, 4 * 5 + 1),
                   (3 * 5 + 4, 1 * 5 + 1)):
        A, B = int(tabs.PT[la]), int(tabs.PT[lb])
        want = int(tabs.ST[A * 8 + B]) if A <= 6 and B <= 6 else 0
        assert int(tabs.SE[la * 25 + lb]) == want
    assert (tabs.SE != 0).any()
    state = eng.init_state(["GGGAAACCCAAAGGGAAACCC", "GCGCAAAAGCGC"])
    for _ in range(3):
        state = eng.step(state)
    assert len(calls) == 1 and eng.wtabs is tabs
    with pytest.raises(ValueError):
        WT.small_tables(eng.dp, np.ones((5, 5)), "cpu")


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "degenerate",
                                  "edges"])
def test_check_layout_accepts_contract_layouts(case):
    assert _port(_layout(case), fn=WT.check_layout) is None


@pytest.mark.parametrize("fault", ["tail position", "tail code", "descending",
                                   "repeated", "position N", "mlen", "min_hp"])
def test_check_layout_refuses(fault):
    """Each way out of the contract is named; outside it the twin (the
    kernel's algorithm) need not give the step-by-step tables."""
    import dataclasses
    rc, rp, ml, z1, z2 = (np.array(x) for x in _layout("degenerate"))
    cfg = CFG
    if fault == "tail position":
        rp[0, 1, 3] = 9                    # a position past mlen
    elif fault == "tail code":
        rc[0, 2, 5] = 1
    elif fault == "descending":
        rp[0, 2, :2] = [11, 10]
    elif fault == "repeated":
        rp[0, 2, :2] = [10, 10]
    elif fault == "position N":
        rp[0, 2, 1] = CFG.N
    elif fault == "mlen":
        ml[1, 0] = -1
    else:
        cfg = dataclasses.replace(CFG, min_hp=-1)
    with pytest.raises(ValueError, match="layout contract"):
        _port((rc, rp, ml, z1, z2), fn=WT.check_layout, cfg=cfg)


def test_fold_steps_keep_layout_contract(monkeypatch):
    """Every step of real folds hands the wrapper tensors that keep the
    contract (what _regions produces), and on them the kernel's
    algorithm gives the step-by-step tables."""
    seen = []
    real = FT.wavefront_tables

    def spy(*args):
        WT.check_layout(*args)
        want, got = real(*args), WT.wavefront_tables_closed(*args)
        assert all(torch.equal(got[k], want[k]) for k in WT.KEYS)
        seen.append(int(args[4].sum()))
        return want

    monkeypatch.setattr(FT, "wavefront_tables", spy)
    eng = FT.FoldEngine(FT.EngineConfig(N=48, K=6, R=6, M=24, V=128, CPLX=32,
                                        S=512, max_branch=64), B=3,
                        device="cpu")
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list("ACGU"), size=n)) for n in (48, 31, 40, 12)]
    seqs.append("GGGGAAAACCCCUUUUGGGGAAAACCCCGGGGAAAACCCCUUUUGGGG")
    out = list(eng.run_stream(seqs))
    assert len(out) == len(seqs)
    assert len(seen) >= 4 and min(seen) < max(seen)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "degenerate",
                                  "edges"])
def test_cuda_kernel_matches_ref(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    arrays = _layout(case)
    want = _port(arrays, fn=WT.wavefront_tables_ref, device="cuda")
    launches = WT.LAUNCHES
    got = _port(arrays, device="cuda")
    torch.cuda.synchronize()
    assert WT.LAUNCHES == launches + 1
    for k in want:
        assert torch.equal(got[k], want[k]), k
