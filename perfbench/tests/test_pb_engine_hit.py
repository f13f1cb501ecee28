"""api_engine_hit_pct (perfbench/metrics/api_engine_hit_pct.py): the share
of fold() calls in a traced fold_api slice that found their engine kept,
read from the program's counters fold.engine_hits / fold.engine_misses;
None in the other driver's run, without the counters, without a graph
replayed or on a program that does not trace itself."""

import sys

import pytest

from perfbench import core

HIT = "api_engine_hit_pct"


def _span(calls, total_s, self_s=None):
    return dict(calls=calls, total_s=total_s,
                self_s=total_s if self_s is None else self_s)


# an api slice: 2 fold() calls of 400 ms that each built, warmed up and
# captured an engine
API_SNAP = dict(
    spans={"fold.call": _span(2, 0.8, 0.05), "engine.build": _span(2, 0.01),
           "engine.warmup": _span(2, 0.3), "engine.capture": _span(2, 0.2),
           "engine.copy_in": _span(40, 0.01), "engine.launch": _span(40, 0.02),
           "engine.read": _span(42, 0.03), "engine.structures": _span(42, 0.18),
           "stage.loops": _span(2, 0.05)},
    counters={"stage.rounds": 2}, stage_ms={}, process={})
# the same 2 calls, both of which found their engine kept: no engine was
# built, warmed up or captured
KEPT = ("engine.build", "engine.warmup", "engine.capture")
HIT_SNAP = dict(API_SNAP, spans={k: v for k, v in API_SNAP["spans"].items()
                                 if k not in KEPT},
                counters=dict(API_SNAP["counters"], **{"fold.engine_hits": 2}))


@pytest.fixture
def planted(monkeypatch):
    """Plant `snap` as the program's snapshot."""
    from rafft_tpu_torch import obs

    def plant(snap):
        monkeypatch.setattr(obs, "snapshot", lambda: snap)
    return plant


def _read(name, ctx):
    return core.Bench().reader(name)(ctx)


def test_engine_hit_pct_reads_100_where_every_call_found_its_engine(planted):
    planted(HIT_SNAP)
    assert _read(HIT, {"driver": "fold_api"}) == 100.0
    # the set-up spans were not entered: their metrics are absent, not 0
    for part in ("build", "warmup", "capture"):
        assert _read(f"api_{part}_ms_per_fold", {"driver": "fold_api"}) is None
    assert _read("api_structures_ms_per_fold", {"driver": "fold_api"}) == \
        pytest.approx(90.0)


def test_engine_hit_pct_reads_50_on_a_hit_and_a_miss(planted):
    planted(dict(API_SNAP, counters=dict(API_SNAP["counters"], **{
        "fold.engine_hits": 1, "fold.engine_misses": 1})))
    assert _read(HIT, {"driver": "fold_api"}) == 50.0


def test_engine_hit_pct_finds_nothing_to_read(planted, monkeypatch):
    planted(HIT_SNAP)
    assert _read(HIT, {"driver": "stream"}) is None
    assert _read(HIT, {}) is None
    # a program that keeps no engine counts neither
    planted(API_SNAP)
    assert _read(HIT, {"driver": "fold_api"}) is None
    # nor is there a reading without a graph replayed, or without obs
    planted(dict(HIT_SNAP, spans={k: v for k, v in HIT_SNAP["spans"].items()
                                  if k != "engine.launch"}))
    assert _read(HIT, {"driver": "fold_api"}) is None
    import rafft_tpu_torch
    monkeypatch.delattr(rafft_tpu_torch, "obs")
    monkeypatch.setitem(sys.modules, "rafft_tpu_torch.obs", None)
    assert _read(HIT, {"driver": "fold_api"}) is None
