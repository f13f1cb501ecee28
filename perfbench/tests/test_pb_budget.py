"""The K=200 cell n200ms200-b128 and the complex-candidate budget's
metrics: cplx_need_peak_pct (perfbench/metrics/cplx_need_peak_pct.py,
the program's high-water counters stream.cplx_need_peak over
stream.cplx_budget) and stream_flagged_pct (stream_flagged_pct.py,
stream.flagged over stream.folds).  Each reader finds nothing in the
other driver's run, without a graph replayed, or on a program that does
not trace itself or count the budget, and reads the right number from a
planted snapshot.  The cell's entries are appended to the accepted
benchmark, which stays as it was but for the cell's name appended to
some workloads lists."""

import hashlib
import json
import os
import sys

import pytest
from conftest import ROOT

from perfbench import core, traffic

CELL = "n200ms200-b128"
BUDGET = ("cplx_need_peak_pct", "stream_flagged_pct")
STAGES = ("swap", "loops", "wavefront", "delta", "complex", "enumerate",
          "pool")
# the accepted stream metrics whose lists take the cell: their readers
# take any stream run
APPENDED = {f"stage_ms_per_round.{s}" for s in STAGES} | {
    "seq_per_s", "device_idle_pct.stream", "step_device_ms_per_round",
    "step_kernels_per_round", "wavefront_roofline_pct"}
# the benchmark before this cell: the lengths of its lists and the sha256
# of its JSON (sort_keys=True) cut to them, the cell's name taken out
BEFORE = {"configs": 2, "workloads": 2, "end_to_end": 4, "per_layer": 24}
BEFORE_SHA256 = \
    "523e51ca049634521bd44773f27b0283bb384b5ca0c09c3a2004b655fbdcecbc"


def _span(calls, total_s):
    return dict(calls=calls, total_s=total_s, self_s=total_s)


# a stream slice of 3 replays that drained 40 folds, 2 of them flagged
COUNTERS = {"stage.rounds": 12, "stream.rounds": 12, "stream.replays": 3,
            "stream.folds": 40, "stream.live_lanes": 36, "stream.lanes": 48}
BUDGET_COUNTERS = {"stream.cplx_need_peak": 384, "stream.cplx_budget": 512,
                   "stream.flagged": 2, "stream.flagged.cplx_budget": 2}
SNAP = dict(spans={"engine.launch": _span(3, 0.006),
                   "engine.read": _span(3, 0.003)},
            counters=dict(COUNTERS, **BUDGET_COUNTERS), stage_ms={},
            process={})
WANT = {"cplx_need_peak_pct": 75.0, "stream_flagged_pct": 5.0}


@pytest.fixture
def planted(monkeypatch):
    """Plant `snap` as the program's snapshot."""
    from rafft_tpu_torch import obs

    def plant(snap):
        monkeypatch.setattr(obs, "snapshot", lambda: snap)
    return plant


def _read(name, ctx):
    return core.Bench().reader(name)(ctx)


@pytest.mark.parametrize("name", BUDGET)
def test_reader_reads_a_planted_snapshot(name, planted):
    planted(SNAP)
    assert _read(name, {"driver": "stream"}) == pytest.approx(WANT[name])
    assert _read(name, {"driver": "fold_api"}) is None
    assert _read(name, {}) is None
    # an empty slice, and a slice of the step run op by op (no replay)
    planted(dict(SNAP, spans={}, counters={}))
    assert _read(name, {"driver": "stream"}) is None
    planted(dict(SNAP, spans={"engine.read": _span(3, 0.003)}))
    assert _read(name, {"driver": "stream"}) is None


@pytest.mark.parametrize("name", BUDGET)
def test_reader_finds_nothing_on_an_older_program(name, planted,
                                                  monkeypatch):
    # a program whose drain counts no budget: the parent of these metrics
    planted(dict(SNAP, counters=COUNTERS))
    assert _read(name, {"driver": "stream"}) is None
    # a program that does not trace itself
    import rafft_tpu_torch
    monkeypatch.delattr(rafft_tpu_torch, "obs")
    monkeypatch.setitem(sys.modules, "rafft_tpu_torch.obs", None)
    assert _read(name, {"driver": "stream"}) is None


def test_no_flagged_fold_reads_zero_and_an_overflow_above_100(planted):
    planted(dict(SNAP, counters=dict(
        COUNTERS, **{"stream.cplx_need_peak": 3072,
                     "stream.cplx_budget": 2048, "stream.flagged": 0})))
    assert _read("stream_flagged_pct", {"driver": "stream"}) == 0.0
    assert _read("cplx_need_peak_pct", {"driver": "stream"}) == 150.0


def _without_cell(entries):
    return [dict(e, workloads=[w for w in e["workloads"] if w != CELL])
            if "workloads" in e else e for e in entries]


def test_the_cell_is_appended_and_what_was_there_is_unchanged():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    before = {k: _without_cell(v[: BEFORE[k]]) for k, v in spec.items()
              if k in BEFORE} | {k: v for k, v in spec.items()
                                 if k not in BEFORE}
    digest = hashlib.sha256(json.dumps(before, sort_keys=True).encode())
    assert digest.hexdigest() == BEFORE_SHA256
    # the cell's name was appended, last, to exactly these lists
    for m in spec["end_to_end"] + spec["per_layer"][: BEFORE["per_layer"]]:
        if m["name"] in APPENDED:
            assert m["workloads"][-1] == CELL, m["name"]
        else:
            assert CELL not in m.get("workloads", []), m["name"]
    # one config, one cell and the two metrics, appended
    assert [c["name"] for c in spec["configs"][BEFORE["configs"]:]] == [
        "rafft-n200-ms200"]
    assert [w["name"] for w in spec["workloads"][BEFORE["workloads"]:]] \
        == [CELL]
    added = spec["per_layer"][BEFORE["per_layer"]:]
    assert [m["name"] for m in added] == list(BUDGET)
    bench = core.Bench()
    layers = {m["layer"] for m in spec["per_layer"][: BEFORE["per_layer"]]}
    for m in added:
        assert callable(bench.reader(m["name"]))
        assert m["layer"] in layers and m["moves"] == "seq_per_s"
        assert m["workloads"] == ["n100ms50-b128", CELL], m["name"]
    assert {m["name"] for m in bench.per_layer(CELL)} == (
        APPENDED - {"seq_per_s"}) | set(BUDGET)
    assert {m["name"] for m in bench.end_to_end(CELL)} == {
        "seq_per_s", "peak_mem_mib", "setup_s"}


def test_the_cell_runs_the_configuration_it_states():
    bench = core.Bench()
    wl = bench.workload(CELL)
    settings = bench.settings(bench.cell(CELL)["config"])
    assert (settings["nb_mode"], settings["max_stack"],
            settings["max_branch"]) == (200, 200, 1000)
    assert wl["driver"] == "stream" and wl["bucket"] == 128
    from rafft_tpu_torch.parallel.sweep import bucket_batch, bucket_config
    cfg = bucket_config(wl["bucket"], 200, 200, 1000)
    assert (cfg.K, cfg.M, cfg.CPLX) == (200, 200, 2048)
    assert bucket_batch(wl["batch"], wl["bucket"]) == 16


def test_a_seed_repeats_its_draw_and_another_changes_it():
    wl = core.Bench().workload(CELL)
    big = 2**31 + 12345
    a = core.draw(wl, big, 51)
    assert a == core.draw(wl, big, 51) and len(a) == 200 * 51
    assert core.draw(wl, big + 1, 51) != a
    # one cycle is the whole band, each row once
    band = traffic.band(*wl["band"])
    assert sorted(a[: wl["strata"]]) == sorted(band)
