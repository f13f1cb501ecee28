"""The fold step's window count: enum_windows_per_step
(perfbench/metrics/enum_windows_per_step.py, the program's counters
stream.enum_windows over stream.enum_steps).  The reader finds nothing in
the other driver's run, without a graph replayed, on a program that does
not trace itself or count the windows, or in a slice in which no lane
enumerated, and reads the right number from a planted snapshot.  The
metric is appended to the accepted benchmark, which stays as it was."""

import hashlib
import json
import os
import sys

import pytest
from conftest import ROOT

from perfbench import core

METRIC = "enum_windows_per_step"
STREAM_CELLS = ["n100ms50-b128", "n200ms200-b128", "n100ms50-b512"]
# the benchmark before this metric: the lengths of its lists and the
# sha256 of its JSON (sort_keys=True) cut to them, the names of every
# later cell taken out of its workloads lists (so that later cells may
# append theirs)
BEFORE = {"configs": 4, "workloads": 4, "end_to_end": 4, "per_layer": 27}
BEFORE_SHA256 = \
    "4b347b9d60ffc134631914ddc97ee5202e54e89ac0d409544cfaea4041e4e73b"


def _span(calls, total_s):
    return dict(calls=calls, total_s=total_s, self_s=total_s)


# a stream slice of 3 replays of 4 rounds at B=16, every lane folding
COUNTERS = {"stage.rounds": 12, "stream.rounds": 12, "stream.replays": 3,
            "stream.folds": 12, "stream.flagged": 0}
WINDOWS = {"stream.enum_windows": 240, "stream.enum_steps": 192}
SNAP = dict(spans={"engine.launch": _span(3, 0.006),
                   "engine.read": _span(3, 0.003)},
            counters=dict(COUNTERS, **WINDOWS), stage_ms={}, process={})


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
    assert _read({"driver": "stream"}) == pytest.approx(1.25)
    assert _read({"driver": "fold_api"}) is None
    assert _read({}) is None
    # an empty slice, and a slice of the step run op by op (no replay)
    planted(dict(SNAP, spans={}, counters={}))
    assert _read({"driver": "stream"}) is None
    planted(dict(SNAP, spans={"engine.read": _span(3, 0.003)}))
    assert _read({"driver": "stream"}) is None


def test_reader_finds_nothing_on_an_older_program(planted, monkeypatch):
    # a program whose step counts no windows: the parent of the metric
    planted(dict(SNAP, counters=COUNTERS))
    assert _read({"driver": "stream"}) is None
    # a slice in which no lane enumerated
    planted(dict(SNAP, counters=dict(COUNTERS, **{
        "stream.enum_windows": 0, "stream.enum_steps": 0})))
    assert _read({"driver": "stream"}) is None
    # a program that does not trace itself
    import rafft_tpu_torch
    monkeypatch.delattr(rafft_tpu_torch, "obs")
    monkeypatch.setitem(sys.modules, "rafft_tpu_torch.obs", None)
    assert _read({"driver": "stream"}) is None


def test_every_lane_step_in_one_window_reads_1(planted):
    planted(dict(SNAP, counters=dict(COUNTERS, **{
        "stream.enum_windows": 192, "stream.enum_steps": 192})))
    assert _read({"driver": "stream"}) == 1.0


def _without_later(entries, accepted):
    return [dict(e, workloads=[w for w in e["workloads"] if w in accepted])
            if "workloads" in e else e for e in entries]


def test_the_metric_is_appended_and_what_was_there_is_unchanged():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    accepted = {w["name"] for w in spec["workloads"][: BEFORE["workloads"]]}
    assert set(STREAM_CELLS) <= accepted
    before = {k: _without_later(v[: BEFORE[k]], accepted)
              for k, v in spec.items()
              if k in BEFORE} | {k: v for k, v in spec.items()
                                 if k not in BEFORE}
    digest = hashlib.sha256(json.dumps(before, sort_keys=True).encode())
    assert digest.hexdigest() == BEFORE_SHA256
    # the metric, the first entry after the accepted ones, in the accepted
    # step layer, reported in the three stream cells
    m = spec["per_layer"][BEFORE["per_layer"]]
    assert m["name"] == METRIC
    layers = {m["layer"] for m in spec["per_layer"][: BEFORE["per_layer"]]}
    assert m["layer"] in layers and m["layer"].startswith("fold step")
    assert m["moves"] == "seq_per_s" and m["better"] == "lower"
    assert m["unit"] == "windows" and m["source"] == "program_counter"
    assert m["workloads"][:3] == STREAM_CELLS
    assert callable(core.Bench().reader(METRIC))
    bench = core.Bench()
    for cell in STREAM_CELLS:
        assert METRIC in {x["name"] for x in bench.per_layer(cell)}, cell
    assert METRIC not in {x["name"] for x in bench.per_layer("ms20traj-api")}
