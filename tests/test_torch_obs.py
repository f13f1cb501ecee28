"""The program's own trace (rafft_tpu_torch/obs.py): spans, counters and
the fold step's stage clocks, recorded while torch.profiler records and
only then.

The CPU tests fold eagerly at N=32.  The `cuda` test (it skips without a
card) holds the stage clocks that a CUDA graph replay records to the
kernel time of the same replays; this file imports no JAX, so it runs on
the card's machine (tests/conftest.py imports JAX: leave it out there):

    python -m pytest --noconftest tests/test_torch_obs.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rafft_tpu_torch import obs
from rafft_tpu_torch.engine import fold_torch as FT

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

CFG = FT.EngineConfig(N=32, K=3, R=4, M=12, V=32, CPLX=8, S=128,
                      max_branch=24, max_steps=8)
SEQS = ["GGGAAACCCAAAGGGAAACCC", "GCGCUUCGGCGCGC",
        "GGGGAAAACCCCAAGGGGAAAACCCC", "ACGUACGUAGCUAGCUAGGCAU",
        "GGCGCAAGCCUUCGGGCUUGCGCC"]
STEP_STAGES = [s for s in FT.STAGES if s != "swap"]
G = 2


def _stream(device="cpu", graphs=False, B=2):
    eng = FT.FoldEngine(CFG, B=B, device=device, graphs=graphs)
    return sorted(eng.run_stream(SEQS, G))


def _fold():
    final, traj = FT.fold(SEQS[0], 8, 2, 16, traj=True, device="cpu")
    return ([(s.str_struct, s.energy) for s in final],
            [[(s.str_struct, s.energy) for s in beam] for beam in traj])


def _calls(monkeypatch, name):
    """Count the calls of FoldEngine.<name> from now on."""
    calls = [0]
    orig = getattr(FT.FoldEngine, name)

    def counted(self, *args):
        calls[0] += 1
        return orig(self, *args)
    monkeypatch.setattr(FT.FoldEngine, name, counted)
    return calls


def _profiled(fn, cuda=False):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    obs.clear()
    with profile(activities=acts) as prof:
        out = fn()
    return out, prof, obs.snapshot()


def test_nothing_is_recorded_without_a_profiler():
    obs.clear()
    _stream()
    _fold()
    snap = obs.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}
    assert snap["stage_ms"] == {}
    assert set(snap["process"]) == {"wavefront.launches",
                                    "wavefront.captured", "delta.launches",
                                    "delta.captured", "enumerate.launches",
                                    "enumerate.captured", "fold.refolds"}


def test_run_stream_records_every_stage_once_per_round(monkeypatch):
    steps = _calls(monkeypatch, "step")
    advances = _calls(monkeypatch, "_advance")
    _, _, snap = _profiled(_stream)
    spans, counters = snap["spans"], snap["counters"]
    rounds = counters["stage.rounds"]
    assert rounds == steps[0] == G * advances[0] > 0
    assert counters["stream.rounds"] == rounds
    assert counters["stream.replays"] == advances[0]
    assert counters["stream.folds"] == len(SEQS)
    for stage in STEP_STAGES:
        assert spans["stage." + stage]["calls"] == rounds, stage
    # the swap stage of a round holds its gate and swap and the previous
    # round's merge; the last round's merge and the final swap are one more
    assert spans["stage.swap"]["calls"] == rounds + advances[0]
    for name in ("engine.read", "engine.rows", "stream.encode",
                 "stream.load"):
        assert spans[name]["calls"] > 0, name
    assert spans["engine.rows"]["calls"] == len(SEQS)


def test_fold_records_every_stage_once_per_step(monkeypatch):
    # the fold builds its engine: none is kept from an earlier test's fold
    FT.release_engines()
    steps = _calls(monkeypatch, "step")
    _, _, snap = _profiled(_fold)
    spans = snap["spans"]
    assert snap["counters"]["stage.rounds"] == steps[0] > 0
    for stage in STEP_STAGES:
        assert spans["stage." + stage]["calls"] == steps[0], stage
    assert "stage.swap" not in spans
    assert spans["fold.call"]["calls"] == 1
    assert spans["engine.build"]["calls"] == 1
    # the trajectory's beams before every step, and the final beam
    assert spans["engine.structures"]["calls"] == steps[0] + 1


def test_every_span_is_a_profiler_range():
    """Each span's calls are the profiler's ranges of its name, and its
    time theirs, within 1 ms a call."""
    _, prof, snap = _profiled(lambda: (_stream(), _fold()))
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(obs.PREFIX):
            r = ranges.setdefault(ev.name()[len(obs.PREFIX):], [0, 0])
            r[0] += 1
            r[1] += ev.end_ns() - ev.start_ns()
    assert set(ranges) == set(snap["spans"])
    assert sum(s["calls"] for s in snap["spans"].values()) > 50
    for name, s in snap["spans"].items():
        calls, ns = ranges[name]
        assert calls == s["calls"], name
        assert s["total_s"] == pytest.approx(ns / 1e9, abs=1e-3 * calls), name


def test_self_time_is_the_span_less_its_children():
    """A fold() call's spans are each directly inside its fold.call (the
    eager step's stages too), so fold.call's time less its self time is
    theirs; a stream's spans are outermost, all self time."""
    _, _, snap = _profiled(_fold)
    spans = snap["spans"]
    call = spans.pop("fold.call")
    inside = sum(s["total_s"] for s in spans.values())
    assert inside > 0
    assert call["total_s"] - call["self_s"] == pytest.approx(inside,
                                                             abs=1e-6)
    for name, s in spans.items():
        assert s["self_s"] == s["total_s"], name
    _, _, snap = _profiled(_stream)
    for name, s in snap["spans"].items():
        assert 0 < s["self_s"] == s["total_s"], name


def test_a_stream_reads_the_device_once_a_replay():
    """Each replay's banked folds leave by its one read (_fetch), the
    draw's last folds too: on two lanes over five sequences the last
    folds finish after the draw is exhausted."""
    out, _, snap = _profiled(_stream)
    assert [i for i, _, _ in out] == list(range(len(SEQS)))
    replays = snap["counters"]["stream.replays"]
    assert snap["spans"]["engine.read"]["calls"] == replays > 0


def test_live_lanes_are_at_most_the_lanes():
    _, _, snap = _profiled(lambda: _stream(B=3))
    c = snap["counters"]
    assert 0 < c["stream.live_lanes"] <= c["stream.lanes"]
    assert c["stream.lanes"] == 3 * c["stream.replays"]


def test_a_high_water_counter_keeps_the_largest_value():
    obs.clear()
    obs.high("h", 9)                      # nothing records
    with profile(activities=[ProfilerActivity.CPU]):
        for v in (3, 0, 7, 5):
            obs.high("h", v)
        obs.high("z", 0)
    assert obs.snapshot()["counters"] == {"h": 7, "z": 0}


# random 40-63 nt sequences at N=64, whose steps offer 0 to 10 complex
# candidates
CPLX_CFG = FT.EngineConfig(N=64, K=4, R=8, M=24, V=64, S=256, max_branch=64,
                           max_steps=8)
_rng = np.random.default_rng(7)
CPLX_SEQS = ["".join(_rng.choice(list("ACGU"), int(_rng.integers(40, 64))))
             for _ in range(5)]


@pytest.mark.parametrize("cplx", [2, 512])
def test_stream_counts_flags_by_cause_and_the_peak_need(cplx):
    """stream.flagged and stream.flagged.<cause> count the folds
    yielded with a flag bit, by cause; stream.cplx_need_peak is the
    largest cplx_need of the folds, which overflowed the budget
    stream.cplx_budget exactly where a fold is flagged cplx_budget."""
    eng = FT.FoldEngine(dataclasses.replace(CPLX_CFG, CPLX=cplx), B=2,
                        device="cpu")
    needs = {}
    out, _, snap = _profiled(lambda: list(eng.run_stream(CPLX_SEQS, G,
                                                         needs=needs)))
    c = snap["counters"]
    flags = {i: flag for i, _, flag in out}
    assert sorted(needs) == sorted(flags) == list(range(len(CPLX_SEQS)))
    r_needs = {i: r for i, (_, r) in needs.items()}
    needs = {i: n for i, (n, _) in needs.items()}
    assert c["stream.folds"] == len(CPLX_SEQS)
    assert c["stream.flagged"] == sum(f != 0 for f in flags.values())
    for bit, cause in FT.FLAG_NAMES.items():
        assert c.get("stream.flagged." + cause, 0) == sum(
            bool(f & bit) for f in flags.values()), cause
    assert c["stream.cplx_budget"] == cplx
    assert c["stream.cplx_need_peak"] == max(needs.values()) > 2
    assert c["stream.rslot_need_peak"] == max(r_needs.values()) > 0
    assert c["stream.rslots"] == CPLX_CFG.R
    for i, need in needs.items():
        assert bool(flags[i] & FT.FLAG_CPLX) == (need > cplx), i
    if cplx == 2:
        assert c["stream.flagged.cplx_budget"] > 0
    else:
        assert c["stream.flagged"] == 0
    # the same folds, untraced
    assert sorted(eng.run_stream(CPLX_SEQS, G)) == sorted(out)


def test_answers_are_bit_equal_with_and_without_the_profiler():
    plain = (_stream(), _fold())
    traced, _, snap = _profiled(lambda: (_stream(), _fold()))
    assert traced == plain
    assert snap["counters"]["stage.rounds"] > 0


def test_spans_nest():
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("a"):
            with obs.span("b"):
                with obs.span("c"):
                    obs.count("n", 2)
            with obs.span("c"):
                pass
        obs.count("n")
    snap = obs.snapshot()
    a, b, c = (snap["spans"][k] for k in "abc")
    assert (a["calls"], b["calls"], c["calls"]) == (1, 1, 2)
    assert c["self_s"] == c["total_s"]
    assert 0 <= b["self_s"] < b["total_s"] < a["total_s"]
    # a's children are b and the second c; the first c is b's
    first_c = b["total_s"] - b["self_s"]
    assert a["self_s"] == pytest.approx(
        a["total_s"] - b["total_s"] - (c["total_s"] - first_c), abs=1e-9)
    assert snap["counters"] == {"n": 3}
    obs.clear()
    assert obs.snapshot()["spans"] == {}


def test_a_stage_that_goes_on_is_one_span():
    clock = obs.HostStages()
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        clock.to("swap")
        clock.to("swap")
        assert not clock.idle
        clock.to("loops")
        clock.to(None)
        assert clock.idle
    spans = obs.snapshot()["spans"]
    assert spans["stage.swap"]["calls"] == 1
    assert spans["stage.loops"]["calls"] == 1


class _Event:
    """A recorded timing event at a fixed device time (ms)."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_graph_stages_put_each_interval_down_to_its_stage():
    clock = obs.GraphStages()
    clock.marks = [("swap", _Event(0.0)), ("loops", _Event(1.0)),
                   ("pool", _Event(4.0)), (None, _Event(6.5)),
                   ("loops", _Event(7.0)), (None, _Event(9.0))]
    clock.rounds = 2
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        clock.read()
    snap = obs.snapshot()
    # the gap between an end and the next start is no stage's
    assert snap["stage_ms"] == {"swap": 1.0, "loops": 5.0, "pool": 2.5}
    assert snap["counters"] == {"stage.rounds": 2}


def test_graph_stage_marks(monkeypatch):
    """The events a capture of _advance would record, with the copy back
    into the static buffers timed with the last stage."""
    class Recorded:
        def __init__(self, **flags):
            assert flags == dict(enable_timing=True, external=True)

        def record(self):
            pass
    monkeypatch.setattr(obs.torch.cuda, "Event", Recorded)
    clock = obs.GraphStages()
    clock.to(None)
    assert clock.idle and clock.marks == []
    for name in ("swap", "loops", "pool", "swap", "swap", "loops", "pool",
                 "swap", None, None):
        clock.to(name)
    clock.resume()
    clock.to(None)
    assert [name for name, _ in clock.marks] == [
        "swap", "loops", "pool", "swap", "loops", "pool", "swap", None,
        "swap", None]


def _graph_kernel_s(prof):
    """Device seconds of the kernels that CUDA graph launches ran."""
    launches, kernels = set(), []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.correlation_id(), ev.end_ns() - ev.start_ns(),
                            ev.name()))
        elif ev.name() in ("cudaGraphLaunch", "cuGraphLaunch"):
            launches.add(ev.correlation_id())
    return sum(d for corr, d, name in kernels
               if corr in launches and not name.startswith(obs.PREFIX)) / 1e9


GRAPH_CFG = FT.EngineConfig(N=64, K=20, R=8, M=48, V=256, W=4, CPLX=128,
                            S=4096, max_branch=256, max_steps=10)


@pytest.mark.cuda
def test_graph_stage_clocks_cover_the_replays_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    cfg = GRAPH_CFG
    seqs = [s * 2 for s in SEQS] * 4
    eng = FT.FoldEngine(cfg, B=4, device="cuda")
    plain = sorted(eng.run_stream(seqs, 4))          # captures the graph
    assert ("_advance", 4) in eng._graphs
    before = obs.snapshot()["process"]
    traced, prof, snap = _profiled(lambda: sorted(eng.run_stream(seqs, 4)),
                                   cuda=True)
    assert traced == plain
    stage_ms = snap["stage_ms"]
    assert set(stage_ms) == set(FT.STAGES)
    assert all(ms > 0 for ms in stage_ms.values()), stage_ms
    c = snap["counters"]
    assert c["stage.rounds"] == c["stream.rounds"] == 4 * c["stream.replays"]
    # the drain's counters read what the replays banked
    assert c["stream.cplx_budget"] == cfg.CPLX
    assert c["stream.flagged"] == sum(f != 0 for _, _, f in traced)
    assert 0 < c["stream.cplx_need_peak"] <= cfg.K * cfg.R * cfg.M
    # every round of a replay ran both kernels, as the process counters say
    p = snap["process"]
    assert p["delta.captured"] > 0 and p["wavefront.captured"] > 0
    for k in ("delta.launches", "wavefront.launches"):
        assert p[k] - before[k] == c["stream.rounds"], k
    kernel_s = _graph_kernel_s(prof)
    assert kernel_s > 0
    total_s = sum(stage_ms.values()) / 1e3
    assert total_s >= kernel_s, (total_s, kernel_s)


@pytest.mark.cuda
def test_a_slice_begun_mid_stream_times_every_round_it_reads():
    """A profiler started between two yields, after a synchronize, as
    the benchmark's traced slice starts, finds the next replay launched
    already (run_stream launches it before it yields): the read that
    waits for that replay reads its stage clock too, so every round the
    slice's reads count was timed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    seqs = [s * 2 for s in SEQS] * 4
    eng = FT.FoldEngine(GRAPH_CFG, B=4, device="cuda")
    plain = list(eng.run_stream(seqs, 4))            # captures the graph
    stream = eng.run_stream(seqs, 4)
    got = [next(stream)]

    def some():
        got.extend(next(stream) for _ in range(len(seqs) // 2))
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    _, _, snap = _profiled(some, cuda=True)
    got += list(stream)
    assert got == plain
    c = snap["counters"]
    assert c["stream.rounds"] > 0
    assert c["stage.rounds"] == c["stream.rounds"] == 4 * c["stream.replays"]
    assert c["stream.ahead"] > 0
