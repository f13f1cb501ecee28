"""The 257-512 nt cell n100ms50-b512 and the region slots' metric:
rslot_need_peak_pct (perfbench/metrics/rslot_need_peak_pct.py, the
program's high-water counters stream.rslot_need_peak over
stream.rslots).  The reader finds nothing in the other driver's run,
without a graph replayed, or on a program that does not trace itself or
count the slots, and reads the right number from a planted snapshot.
The cell's configuration (the corpus benchmark's 257-512 nt rows, at
its settings), the cell and the metric are appended to the accepted
benchmark, which stays as it was but for the cell's name appended to
some workloads lists."""

import hashlib
import json
import os
import sys

import pytest
from conftest import ROOT

from perfbench import core, traffic

CELL = "n100ms50-b512"
CONFIG = "rafft-n100-ms50-b512"
METRIC = "rslot_need_peak_pct"
STAGES = ("swap", "loops", "wavefront", "delta", "complex", "enumerate",
          "pool")
# the accepted stream metrics whose lists take the cell
APPENDED = {f"stage_ms_per_round.{s}" for s in STAGES} | {
    "seq_per_s", "device_idle_pct.stream", "step_device_ms_per_round",
    "step_kernels_per_round", "wavefront_roofline_pct", "cplx_need_peak_pct",
    "stream_flagged_pct", "stream_live_lane_pct", "stream_host_ms_per_fold",
    "stream_drain_ms_per_fold", "stream_copyin_ms_per_replay"}
# the benchmark before this cell: the lengths of its lists and the sha256
# of its JSON (sort_keys=True) cut to them, the names of this and every
# later cell taken out (so that later cells may append theirs)
BEFORE = {"configs": 3, "workloads": 3, "end_to_end": 4, "per_layer": 26}
BEFORE_SHA256 = \
    "82f74766c01658b0db5626f4a9dbd53d526dc99e044b4153c774350a3bc0e671"


def _span(calls, total_s):
    return dict(calls=calls, total_s=total_s, self_s=total_s)


# a stream slice of 3 replays that drained 12 folds
COUNTERS = {"stage.rounds": 12, "stream.rounds": 12, "stream.replays": 3,
            "stream.folds": 12, "stream.flagged": 0}
SLOTS = {"stream.rslot_need_peak": 18, "stream.rslots": 24}
SNAP = dict(spans={"engine.launch": _span(3, 0.006),
                   "engine.read": _span(3, 0.003)},
            counters=dict(COUNTERS, **SLOTS), stage_ms={}, process={})


@pytest.fixture
def planted(monkeypatch):
    """Plant `snap` as the program's snapshot."""
    from rafft_tpu_torch import obs

    def plant(snap):
        monkeypatch.setattr(obs, "snapshot", lambda: snap)
    return plant


def _read(ctx):
    return core.Bench().reader(METRIC)(ctx)


def test_reader_reads_a_planted_snapshot(planted):
    planted(SNAP)
    assert _read({"driver": "stream"}) == pytest.approx(75.0)
    assert _read({"driver": "fold_api"}) is None
    assert _read({}) is None
    # an empty slice, and a slice of the step run op by op (no replay)
    planted(dict(SNAP, spans={}, counters={}))
    assert _read({"driver": "stream"}) is None
    planted(dict(SNAP, spans={"engine.read": _span(3, 0.003)}))
    assert _read({"driver": "stream"}) is None


def test_reader_finds_nothing_on_an_older_program(planted, monkeypatch):
    # a program whose drain counts no region slots: the parent of the
    # metric
    planted(dict(SNAP, counters=COUNTERS))
    assert _read({"driver": "stream"}) is None
    # a program that does not trace itself
    import rafft_tpu_torch
    monkeypatch.delattr(rafft_tpu_torch, "obs")
    monkeypatch.setitem(sys.modules, "rafft_tpu_torch.obs", None)
    assert _read({"driver": "stream"}) is None


def test_an_overflow_reads_above_100(planted):
    planted(dict(SNAP, counters=dict(
        COUNTERS, **{"stream.rslot_need_peak": 20, "stream.rslots": 16})))
    assert _read({"driver": "stream"}) == 125.0


def _without_later(entries, accepted):
    return [dict(e, workloads=[w for w in e["workloads"] if w in accepted])
            if "workloads" in e else e for e in entries]


def test_the_cell_is_appended_and_what_was_there_is_unchanged():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    accepted = {w["name"] for w in spec["workloads"][: BEFORE["workloads"]]}
    before = {k: _without_later(v[: BEFORE[k]], accepted)
              for k, v in spec.items()
              if k in BEFORE} | {k: v for k, v in spec.items()
                                 if k not in BEFORE}
    digest = hashlib.sha256(json.dumps(before, sort_keys=True).encode())
    assert digest.hexdigest() == BEFORE_SHA256
    # the cell's name was appended, after the accepted cells' names and
    # before any later cell's, to exactly these lists
    for m in spec["end_to_end"] + spec["per_layer"][: BEFORE["per_layer"]]:
        later = [w for w in m.get("workloads", []) if w not in accepted]
        if m["name"] in APPENDED:
            assert later[:1] == [CELL], m["name"]
        else:
            assert CELL not in later, m["name"]
    # the config, the cell and the metric, each the first entry after the
    # accepted ones
    config = spec["configs"][BEFORE["configs"]]
    assert config["name"] == CONFIG and config["reduced"] == []
    assert config["source"] not in {
        c["source"] for c in spec["configs"][: BEFORE["configs"]]}
    assert spec["workloads"][BEFORE["workloads"]]["name"] == CELL
    cell = spec["workloads"][BEFORE["workloads"]]
    assert (cell["config"], cell["chips"]) == (CONFIG, 1)
    m = spec["per_layer"][BEFORE["per_layer"]]
    assert m["name"] == METRIC
    layers = {m["layer"] for m in spec["per_layer"][: BEFORE["per_layer"]]}
    assert callable(core.Bench().reader(METRIC))
    assert m["layer"] in layers and m["moves"] == "seq_per_s"
    assert m["better"] == "lower" and m["unit"] == "%"
    assert m["workloads"][:3] == [CELL, "n100ms50-b128", "n200ms200-b128"]
    bench = core.Bench()
    ours = {m["name"] for m in spec["per_layer"][: BEFORE["per_layer"] + 1]}
    assert {m["name"] for m in bench.per_layer(CELL)} & ours == (
        APPENDED - {"seq_per_s"}) | {METRIC}
    assert {m["name"] for m in bench.end_to_end(CELL)} == {
        "seq_per_s", "peak_mem_mib", "setup_s"}


def test_the_cell_runs_the_sweeps_512_bucket():
    bench = core.Bench()
    wl = bench.workload(CELL)
    settings = bench.settings(bench.cell(CELL)["config"])
    # the corpus benchmark's settings, on its 257-512 nt rows
    assert settings == bench.settings("rafft-n100-ms50")
    config = core.load_json(os.path.join(ROOT, "perfbench", "configs",
                                         f"{CONFIG}.json"))
    assert config["band"] == wl["band"] and config["rows"] == wl["strata"]
    assert (settings["nb_mode"], settings["max_stack"],
            settings["max_branch"]) == (100, 50, 1000)
    assert wl["driver"] == "stream" and wl["bucket"] == 512
    from rafft_tpu_torch.parallel.sweep import bucket_batch, bucket_config
    cfg = bucket_config(wl["bucket"], 100, 50, 1000)
    assert (cfg.N, cfg.K, cfg.M, cfg.R, cfg.W, cfg.CPLX) == (
        512, 50, 100, 24, 24, 1024)
    assert bucket_batch(wl["batch"], wl["bucket"]) == 8


def test_a_cycle_is_the_whole_band_in_a_seeded_order():
    wl = core.Bench().workload(CELL)
    big = 2**31 + 54321
    a = core.draw(wl, big, 51)
    assert a == core.draw(wl, big, 51) and len(a) == 200 * 51
    assert core.draw(wl, big + 1, 51) != a
    band = traffic.band(*wl["band"])
    assert len(band) == wl["strata"] == 252
    assert sorted(a[: wl["strata"]]) == sorted(band)
    assert max(map(len, band)) == 509 and min(map(len, band)) == 257
