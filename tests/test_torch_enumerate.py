"""The fold step's stage enumerate (engine/enumerate.py): the plain
version moved out of FoldEngine.step, the wrapper and its checks, the
enumeration counters, and on a card the kernel csrc/enumerate.cu against
the plain version on every output field.

The CPU tests hold the plain version, step by step inside the port's own
steps, to the JAX engine (the step the code was moved from equalled it
bit for bit), show that each edge case of the walk occurs where it
should (a lane capped in its first window, the post-cap first combos
past the last window, done lanes, seen-set overflow, the V-window and
region-slot flags, V not a power of two), and check the running totals
enum_windows and enum_steps on a hand-checked fold.  The tests marked
`cuda` compare the kernel with the plain version on the inputs of real
fold steps at the main path's shapes and on the edge cases, and skip
without a card.  This file imports JAX only inside its CPU parity test,
so it runs on the card's machine (tests/conftest.py imports JAX: leave
it out there):

    python -m pytest --noconftest tests/test_torch_enumerate.py -m cuda
"""

import numpy as np
import pytest
import torch

from rafft_tpu_torch import obs
from rafft_tpu_torch.convert import state_to_numpy
from rafft_tpu_torch.engine import enumerate as EN
from rafft_tpu_torch.engine import fold_torch as FT
from rafft_tpu_torch.engine.fold_torch import (EngineConfig, FoldEngine,
                                               fold_one_config)
from rafft_tpu_torch.parallel.sweep import bucket_config
from rafft_tpu_torch.tools.corpus import journal
from rafft_tpu_torch.tools.measure import step_calls

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

CFG32 = dict(N=32, K=50, R=8, M=32, V=256, W=4, CPLX=128, S=2048,
             max_branch=256, max_steps=10)
CFG64_K200 = dict(N=64, K=200, R=8, M=48, V=512, W=4, CPLX=512, S=6400,
                  max_branch=400, max_steps=10)


def _random(seed, count, lo, hi):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGU"), int(rng.integers(lo, hi + 1))))
            for _ in range(count)]


# edge case: (configuration, sequences, steps); each shows in its steps
EDGES = {
    # max_branch 10 of V=64 slots: lanes reach the cap in their first window
    "capped_first_window": (dict(CFG32, V=64, max_branch=10),
                            _random(32, 3, 20, 32), 4),
    # two windows of 64 and a cap of 20: later rows' first combos lie past
    # the last window (mode M_FIRST)
    "first_past_window": (dict(N=64, K=50, R=8, M=48, V=64, W=2, CPLX=128,
                               S=4096, max_branch=20, max_steps=10),
                          _random(37, 3, 40, 64), 4),
    # a row without a possible pair is done after its first step; an empty
    # lane is done from the start
    "done_lanes": (CFG32, ["A" * 24, ""] + _random(33, 1, 24, 32), 3),
    # a seen set of 40 slots overflows
    "seen_overflow": (dict(CFG32, S=40),
                      ["GGGAAACCCAUGC", "GGGGAAACCCCGGGGAAACCCCAAGGGAAACC"],
                      3),
    # two windows of 20 slots do not reach max_branch: FLAG_VWINDOW
    "v_window": (dict(N=64, K=20, R=8, M=48, V=20, W=2, CPLX=128, S=2048,
                      max_branch=1000, max_steps=8),
                 _random(40, 3, 40, 64), 3),
    # two region slots: new structures with more live regions (r_slots)
    "r_slots": (dict(N=64, K=20, R=2, M=48, V=256, W=4, CPLX=128, S=2048,
                     max_branch=256, max_steps=8),
                _random(41, 3, 48, 64), 4),
    # V = 100 and 300, no power of two nor a multiple of a warp
    "v_100": (dict(N=64, K=20, R=8, M=48, V=100, W=3, CPLX=128, S=4096,
                   max_branch=150, max_steps=10), _random(64, 4, 40, 64), 4),
    "v_300": (dict(N=128, K=20, R=8, M=48, V=300, W=3, CPLX=128, S=4096,
                   max_branch=1000, max_steps=10), _random(65, 3, 100, 128),
              3),
}


def _calls(cfg, seqs, steps, device):
    eng = FoldEngine(EngineConfig(**cfg) if isinstance(cfg, dict) else cfg,
                     B=len(seqs), device=device, graphs=False)
    return step_calls("enumerate_combos", eng, seqs, steps)


def _same(got, want, what):
    (go, gb), (wo, wb) = got, want
    for name, g, w in ([(k, go[k], wo[k]) for k in EN.OUT_KEYS]
                       + [(f"bm.{k}", gb[k], wb[k]) for k in EN.BM_KEYS]):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].tolist()
            raise AssertionError(f"{what}: {name} differs at {bad}")


# ----------------------------------------------------------------------
# CPU
# ----------------------------------------------------------------------

@pytest.mark.parametrize("which", ["cfg32", "k200"])
def test_plain_version_keeps_the_step_equal_to_jax(which):
    """The step with the enumeration moved out (the plain version on the
    CPU) against the JAX engine's step, after every step: the seen set,
    its count, the flags and the beam the enumeration's top-K built."""
    from rafft_tpu.engine import fold_jax as FJ
    cfg, seqs = ((CFG32, _random(32, 3, 20, 32)) if which == "cfg32"
                 else (CFG64_K200, _random(200, 2, 56, 60)))
    ej = FJ.FoldEngine(FJ.EngineConfig(**cfg), B=len(seqs))
    et = FoldEngine(EngineConfig(**cfg), B=len(seqs), device="cpu")
    st_j, st_t = ej.init_state(seqs), et.init_state(seqs)
    calls = 0
    real = FT.enumerate_combos

    def spy(*args):
        nonlocal calls
        calls += 1
        return real(*args)

    FT.enumerate_combos = spy
    try:
        for step in range(cfg["max_steps"]):
            st_j, st_t = ej._step(st_j), et.step(st_t)
            got = state_to_numpy(st_t)
            for k in ("seen_h1", "seen_h2", "seen_cnt", "enum_suspect", "pt",
                      "energy", "active"):
                np.testing.assert_array_equal(got[k], np.asarray(st_j[k]),
                                              err_msg=f"step {step}: {k}")
            if got["done"].all():
                break
    finally:
        FT.enumerate_combos = real
    assert calls == step + 1 and got["done"].all()


@pytest.fixture(scope="module")
def edge_calls():
    return {name: _calls(cfg, seqs, steps, "cpu")
            for name, (cfg, seqs, steps) in EDGES.items()}


def _outs(calls):
    return [EN._enumerate_combos(*args) for args in calls]


def test_a_lane_is_capped_in_its_first_window(edge_calls):
    cfg = EngineConfig(**EDGES["capped_first_window"][0])
    shown = False
    for args, (out, bm) in zip(edge_calls["capped_first_window"],
                               _outs(edge_calls["capped_first_window"])):
        added = out["seen_cnt"] - args[12].long()
        capped = ((out["windows"] == 1) & (added >= cfg.max_branch)
                  & (out["mode"] != EN.M_NORM))
        shown |= bool(capped.any())
    assert shown


def test_first_combos_past_the_last_window(edge_calls):
    modes = [out["mode"] for out, _ in _outs(edge_calls["first_past_window"])]
    assert any(bool((m == EN.M_FIRST).any()) for m in modes)


def test_done_lanes_leave_everything_as_it_was(edge_calls):
    for args, (out, bm) in zip(edge_calls["done_lanes"],
                               _outs(edge_calls["done_lanes"])):
        done = args[9]
        assert done[1], "the empty lane is done from the start"
        assert (out["windows"][done] == 0).all()
        assert (out["mode"][done] == EN.M_NORM).all()
        assert torch.equal(out["seen_h1"][done], args[10][done])
        assert torch.equal(out["seen_cnt"][done], args[12][done].long())
        assert not bm["valid"][done].any()
        assert (bm["E"][done] == EN.INFE).all()
        assert not bm["tie"][done].any() and not bm["idx"][done].any()
    # the dead row enumerated in its first step only
    assert not edge_calls["done_lanes"][0][9][0]
    assert edge_calls["done_lanes"][1][9][0]


def test_seen_set_overflow_sets_suss(edge_calls):
    S = EDGES["seen_overflow"][0]["S"]
    over = [out for out, _ in _outs(edge_calls["seen_overflow"])
            if out["suss"].any()]
    assert over
    for out in over:
        assert (out["seen_cnt"][out["suss"]] == S - 1).all()


def test_v_window_and_r_slots_flags(edge_calls):
    W = EDGES["v_window"][0]["W"]
    assert any(bool(((out["mode"] == EN.M_NORM) & (out["windows"] == W)).any())
               for out, _ in _outs(edge_calls["v_window"]))
    R = EDGES["r_slots"][0]["R"]
    assert any(bool((out["rneed"] > R).any())
               for out, _ in _outs(edge_calls["r_slots"]))


def test_v_not_a_power_of_two_runs_several_windows(edge_calls):
    for name in ("v_100", "v_300"):
        runs = [out["windows"] for out, _ in _outs(edge_calls[name])]
        assert any(bool((w > 1).any()) for w in runs), name


def test_idle_lanes_stop_at_their_window():
    """A lane's windows are counted until it is capped or exhausted: on
    the stream cells' configuration every lane of real steps finishes in
    its first of W=8 windows."""
    rows = [r["seq"] for r in journal() if 65 <= len(r["seq"]) <= 128][:2]
    calls = _calls(bucket_config(128, 100, 50, 1000), rows, 2, "cpu")
    for out, _ in _outs(calls):
        assert (out["windows"] == 1).all()


def test_wrapper_on_cpu_is_the_plain_version(edge_calls):
    before = EN.LAUNCHES
    for args in edge_calls["capped_first_window"]:
        _same(EN.enumerate_combos(*args), EN._enumerate_combos(*args), "cpu")
    assert EN.LAUNCHES == before


def test_enumeration_totals_on_a_hand_checked_fold():
    """A dead row enumerates in its first step only (one window, then
    done), an empty lane never, and a folding lane once a step until it
    is done; run_stream counts what the totals rose by."""
    cfg = EngineConfig(**CFG32)
    eng = FoldEngine(cfg, B=3, device="cpu")
    seqs = ["A" * 24, ""] + _random(33, 1, 24, 32)
    st = eng.init_state(seqs)
    steps = windows = 0
    for _ in range(cfg.max_steps):
        before = st["done"].clone()
        calls = []
        real = FT.enumerate_combos

        def spy(*args):
            out = real(*args)
            calls.append(out[0]["windows"].clone())
            return out

        FT.enumerate_combos = spy
        try:
            st = eng.step(st)
        finally:
            FT.enumerate_combos = real
        steps += int((~before[2]).item())
        windows += int(calls[0][2])
        assert calls[0][0] == (0 if before[0] else 1)
        assert calls[0][1] == 0
    assert st["enum_steps"].tolist() == [1, 0, steps]
    assert st["enum_windows"].tolist() == [1, 0, windows]
    assert steps >= 2 and windows >= steps
    # a stream's counters: every replay's rise, summed
    obs.clear()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        list(eng.run_stream(seqs[:1] + seqs[2:] + seqs[:1], G=2))
    c = obs.snapshot()["counters"]
    assert c["stream.enum_steps"] >= c["stream.folds"] == 3
    assert c["stream.enum_windows"] >= c["stream.enum_steps"]


def test_enumerate_work_counts_the_entries_the_windows_reach():
    # lane 0 has 6 accepted entries, and one window of V=2 slots reaches at
    # most 2 x R = 4 of them; lane 1 ran no window; lane 2's two windows
    # reach up to 8, more than its 6 entries
    s_r = torch.tensor([[[3, 2], [1, 0]], [[5, 5], [5, 5]],
                        [[3, 2], [1, 0]]], dtype=torch.int32)
    work = EN.enumerate_work(s_r, torch.tensor([1, 0, 2]), V=2, S=10)
    assert work["entries"] == 4 + 0 + 6
    assert work["bytes"] == 10 * 24 + 3 * 2 * 2 * 4 + 9 * 3 * 10 * 8


# each fault: a name and a function of the keyword arguments that breaks one
FAULTS = {
    "Dd_int64": lambda a: a.update(Dd=a["Dd"].long()),
    "Dh1_int32": lambda a: a.update(Dh1=a["Dh1"].int()),
    "s_r_shape": lambda a: a.update(s_r=a["s_r"][:, :1].contiguous()),
    "done_int": lambda a: a.update(done=a["done"].int()),
    "seen_noncontig": lambda a: a.update(seen_h1=torch.nn.functional.pad(
        a["seen_h1"], (0, 1))[:, :-1]),
    "seen_cnt_int64": lambda a: a.update(seen_cnt=a["seen_cnt"].long()),
    "V_too_wide": lambda a: a.update(cfg=EngineConfig(**dict(
        vars(a["cfg"]), V=EN.V_MAX + 1))),
    "K_over_V": lambda a: a.update(cfg=EngineConfig(**dict(
        vars(a["cfg"]), V=a["cfg"].K - 1))),
    "R_too_many": lambda a: a.update(cfg=EngineConfig(**dict(
        vars(a["cfg"]), R=EN.R_MAX + 1))),
    "S_too_large": lambda a: a.update(cfg=EngineConfig(**dict(
        vars(a["cfg"]), S=EN.S_MAX + 1))),
}
ARG_NAMES = ("cfg", "Dd", "Dn", "Dh1", "Dh2", "s_r", "energy", "ph1", "ph2",
             "done", "seen_h1", "seen_h2", "seen_cnt")


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_check_args_refuses(edge_calls, fault):
    kw = dict(zip(ARG_NAMES, edge_calls["v_100"][-1]))
    EN._check_args(**kw)
    FAULTS[fault](kw)
    with pytest.raises(ValueError):
        EN._check_args(**kw)


def test_wrapper_refuses_other_devices(edge_calls):
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in edge_calls["v_100"][0]]
    with pytest.raises(ValueError, match="unsupported device"):
        EN.enumerate_combos(*meta)


def test_replays_count():
    before = EN.LAUNCHES
    EN.KERNEL.count_replay(3)
    assert EN.LAUNCHES == before + 3
    EN.LAUNCHES = before


# ----------------------------------------------------------------------
# card
# ----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the enumerate kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _rows(lo, hi, count):
    return [r["seq"] for r in journal() if lo <= len(r["seq"]) <= hi][:count]


# case: (configuration, B, sequences, steps)
SHAPES = {
    "n100ms50_b128": (lambda: (bucket_config(128, 100, 50, 1000), 16,
                               _rows(65, 128, 16), 4)),
    "n200ms200_b128": (lambda: (bucket_config(128, 200, 200, 1000), 16,
                                _rows(65, 128, 16), 4)),
    "n100ms50_b512": (lambda: (bucket_config(512, 100, 50, 1000), 8,
                               _rows(257, 512, 8), 4)),
    "api_b1_k20": (lambda: (fold_one_config(128, 100, 20, 1000), 1,
                            _rows(65, 128, 1), 6)),
    "k255_s32640": (lambda: (fold_one_config(128, 100, 255, 1000), 2,
                             _rows(100, 128, 2), 4)),
    "n1024_r32": (lambda: (bucket_config(1024, 100, 50, 1000), 2,
                           _rows(513, 1024, 2), 3)),
}


def _kernel_vs_plain(calls, what):
    for i, args in enumerate(calls):
        before = EN.LAUNCHES
        got = EN.enumerate_combos(*args)
        torch.cuda.synchronize()
        assert EN.LAUNCHES == before + 1
        _same(got, EN._enumerate_combos(*args), f"{what} step {i + 1}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_kernel_equals_plain_on_real_steps(card, case):
    cfg, B, seqs, steps = SHAPES[case]()
    if case == "api_b1_k20":
        assert (cfg.V, cfg.S, cfg.K, cfg.R, cfg.M) == (2000, 4096, 20, 16, 100)
    if case == "k255_s32640":
        assert (cfg.K, cfg.S) == (255, 32640)
    if case == "n1024_r32":
        assert (cfg.N, cfg.R, cfg.W) == (1024, 32, 24)
    eng = FoldEngine(cfg, B=B, device=card, graphs=False)
    calls = step_calls("enumerate_combos", eng, seqs, steps)
    assert len(calls) == steps
    _kernel_vs_plain(calls, case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EDGES))
def test_kernel_equals_plain_on_edge_cases(card, case):
    cfg, seqs, steps = EDGES[case]
    _kernel_vs_plain(_calls(cfg, seqs, steps, card), case)


@pytest.mark.cuda
def test_kernel_refuses_before_any_launch(card):
    cfg, seqs, steps = EDGES["v_100"]
    args = list(_calls(cfg, seqs, 1, card)[0])
    before = EN.LAUNCHES
    bad = list(args)
    bad[3] = args[3].int()
    with pytest.raises(ValueError, match="Dh1"):
        EN.enumerate_combos(*bad)
    bad = list(args)
    bad[10] = torch.nn.functional.pad(args[10], (0, 1))[:, :-1]
    with pytest.raises(ValueError, match="contiguous"):
        EN.enumerate_combos(*bad)
    assert EN.LAUNCHES == before


@pytest.mark.cuda
def test_graphed_stream_counts_the_kernel(card):
    cfg = EngineConfig(**CFG32)
    eng = FoldEngine(cfg, B=4, device=card)
    before = EN.LAUNCHES
    list(eng.run_stream(_random(9, 6, 18, 32), G=4))
    assert EN.CAPTURED > 0 and EN.LAUNCHES > before
