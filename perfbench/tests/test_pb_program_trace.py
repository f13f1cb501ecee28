"""The per-layer metrics read from the program's own trace
(perfbench/program_trace.py over rafft_tpu_torch/obs.py): each reader
finds nothing without the program's trace or in the other driver's run,
and reads the right number from a planted snapshot; their BENCHMARK.json
entries are appended to the accepted ones, which stay as they were."""

import hashlib
import json
import os
import sys

import pytest
from conftest import ROOT

from perfbench import core

STAGES = ("swap", "loops", "wavefront", "delta", "complex", "enumerate",
          "pool")
STREAM = {f"stage_ms_per_round.{s}" for s in STAGES} | {
    "stream_copyin_ms_per_replay", "stream_drain_ms_per_fold",
    "stream_live_lane_pct"}
API = {f"api_{m}_ms_per_fold" for m in ("build", "warmup", "capture",
                                        "structures", "unspanned")}
# run()'s steps, which no metric reads (they hold the CUDA profiler's cost)
STEPS = ("engine.copy_in", "engine.launch", "engine.read")
# the accepted benchmark: the lengths of its lists, and the sha256 of its
# JSON (sort_keys=True) cut to them
ACCEPTED = {"configs": 2, "workloads": 2, "end_to_end": 4, "per_layer": 8}
ACCEPTED_SHA256 = \
    "43a715d14b3d3bbeaf1dc53dbdb4357903f88e899a00517304a3a05506c07f8a"


def _span(calls, total_s, self_s=None):
    return dict(calls=calls, total_s=total_s,
                self_s=total_s if self_s is None else self_s)


# a stream slice: 3 replays of G=4 rounds, 40 folds
STREAM_SNAP = dict(
    spans={"engine.launch": _span(3, 0.006), "engine.copy_in": _span(3, 0.0015),
           "engine.read": _span(3, 0.003), "engine.rows": _span(40, 0.05),
           "stream.encode": _span(4, 0.002), "stream.load": _span(4, 0.008)},
    counters={"stage.rounds": 12, "stream.rounds": 12, "stream.replays": 3,
              "stream.folds": 40, "stream.live_lanes": 36, "stream.lanes": 48},
    stage_ms={s: 1.2 * (i + 1) for i, s in enumerate(STAGES)},
    process={})
STREAM_WANT = dict(
    {f"stage_ms_per_round.{s}": 0.1 * (i + 1) for i, s in enumerate(STAGES)},
    stream_copyin_ms_per_replay=0.5,
    stream_drain_ms_per_fold=1.5, stream_live_lane_pct=75.0)
# an api slice: 2 fold() calls of 400 ms
API_SNAP = dict(
    spans={"fold.call": _span(2, 0.8, 0.05), "engine.build": _span(2, 0.01),
           "engine.warmup": _span(2, 0.3), "engine.capture": _span(2, 0.2),
           "engine.copy_in": _span(40, 0.01), "engine.launch": _span(40, 0.02),
           "engine.read": _span(42, 0.03), "engine.structures": _span(42, 0.18),
           "stage.loops": _span(2, 0.05)},
    counters={"stage.rounds": 2}, stage_ms={}, process={})
API_WANT = dict(api_build_ms_per_fold=5.0, api_warmup_ms_per_fold=150.0,
                api_capture_ms_per_fold=100.0, api_structures_ms_per_fold=90.0,
                api_unspanned_ms_per_fold=25.0)


@pytest.fixture
def planted(monkeypatch):
    """Plant `snap` as the program's snapshot."""
    from rafft_tpu_torch import obs

    def plant(snap):
        monkeypatch.setattr(obs, "snapshot", lambda: snap)
    return plant


def _read(name, ctx):
    return core.Bench().reader(name)(ctx)


@pytest.mark.parametrize("name", sorted(STREAM | API))
def test_reader_finds_nothing_without_the_programs_trace(name, monkeypatch,
                                                         planted):
    driver = "stream" if name in STREAM else "fold_api"
    other = "fold_api" if name in STREAM else "stream"
    planted(STREAM_SNAP if name in STREAM else API_SNAP)
    assert _read(name, {"driver": other}) is None
    assert _read(name, {}) is None
    # a program that does not trace itself (an older checkout)
    import rafft_tpu_torch
    monkeypatch.delattr(rafft_tpu_torch, "obs")
    monkeypatch.setitem(sys.modules, "rafft_tpu_torch.obs", None)
    assert _read(name, {"driver": driver}) is None


@pytest.mark.parametrize("name", sorted(STREAM | API))
def test_reader_reads_a_planted_snapshot(name, planted):
    snap, want, driver = ((STREAM_SNAP, STREAM_WANT, "stream")
                          if name in STREAM else
                          (API_SNAP, API_WANT, "fold_api"))
    planted(snap)
    assert _read(name, {"driver": driver}) == pytest.approx(want[name])
    # an empty slice has no denominator
    planted(dict(snap, spans={}, counters={}, stage_ms={}))
    assert _read(name, {"driver": driver}) is None
    # nor has a slice of the step run op by op, with no graph replayed
    eager = {k: v for k, v in snap["spans"].items() if k != "engine.launch"}
    planted(dict(snap, spans=eager))
    assert _read(name, {"driver": driver}) is None


def test_api_metrics_and_the_steps_add_up_to_the_mean_call(planted):
    planted(API_SNAP)
    total = sum(_read(name, {"driver": "fold_api"}) for name in API)
    steps = 1e3 * sum(API_SNAP["spans"][k]["total_s"] for k in STEPS) / 2
    assert total + steps == pytest.approx(1e3 * 0.8 / 2)


def test_stage_metrics_need_every_round_timed(planted):
    planted(dict(STREAM_SNAP, counters=dict(STREAM_SNAP["counters"],
                                            **{"stage.rounds": 8})))
    assert _read("stage_ms_per_round.loops", {"driver": "stream"}) is None


def test_new_entries_are_appended_and_the_accepted_ones_unchanged():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    accepted = {k: (v[: ACCEPTED[k]] if k in ACCEPTED else v)
                for k, v in spec.items()}
    digest = hashlib.sha256(json.dumps(accepted, sort_keys=True).encode())
    assert digest.hexdigest() == ACCEPTED_SHA256
    bench = core.Bench()
    cells = {w["name"] for w in spec["workloads"]}
    layers = {m["layer"] for m in spec["per_layer"][: ACCEPTED["per_layer"]]}
    added = spec["per_layer"][ACCEPTED["per_layer"]:]
    assert {m["name"] for m in added} >= STREAM | API
    for m in added:
        assert os.path.exists(os.path.join(ROOT, "perfbench", "metrics",
                                           m["name"] + ".py")), m["name"]
        assert callable(bench.reader(m["name"]))
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
        assert m["layer"] in layers, m["name"]
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in bench.end_to_end(cell)}
        want = ("n100ms50-b128" if m["name"] in STREAM else "ms20traj-api")
        assert m["workloads"] == [want], m["name"]
