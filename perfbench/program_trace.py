"""What the program records of itself (rafft_tpu_torch/obs.py): its own
spans, counters and the fold step's stage device ms.  The program records
while torch.profiler records and only then, so in a traced run these
readings cover the profiled slice alone.  The metrics describe the card's
path, the fold step replayed as CUDA graphs: a slice with no replay (the
step run op by op, as on the CPU) has nothing to read, nor has a program
without that module, and every reading here is then None."""


def snapshot(ctx, driver):
    """The program's snapshot after a traced run of `driver` whose slice
    replayed the step's graphs, or None (another driver, no replay, or a
    program that does not trace itself)."""
    if ctx.get("driver") != driver:
        return None
    try:
        from rafft_tpu_torch import obs
    except ImportError:
        return None
    snap = obs.snapshot()
    if not snap["spans"].get("engine.launch", {}).get("calls"):
        return None
    return snap


def _ms_per(snap, names, n, key="total_s"):
    """ms in the spans `names` (their total or self time) over n, or None
    where n is 0 or one of them was not entered."""
    spans = snap["spans"]
    if not n or any(name not in spans for name in names):
        return None
    return 1e3 * sum(spans[name][key] for name in names) / n


def stream_ms_per(ctx, names, counter):
    """ms in the program's spans `names` per count of the counter
    `counter` in a traced stream run."""
    snap = snapshot(ctx, "stream")
    if snap is None:
        return None
    return _ms_per(snap, names, snap["counters"].get(counter, 0))


def api_ms_per_fold(ctx, names, key="total_s"):
    """ms in the spans `names` per fold() call (fold.call's calls) of a
    traced fold_api run."""
    snap = snapshot(ctx, "fold_api")
    if snap is None:
        return None
    calls = snap["spans"].get("fold.call", {}).get("calls", 0)
    return _ms_per(snap, names, calls, key)


def stage_ms_per_round(ctx, stage):
    """Device ms of the fold step's stage `stage` per round replayed in a
    traced stream run; read only where every round of the slice had its
    stage clock read."""
    snap = snapshot(ctx, "stream")
    if snap is None:
        return None
    rounds = snap["counters"].get("stage.rounds", 0)
    ms = snap["stage_ms"].get(stage)
    if not rounds or ms is None \
            or rounds != snap["counters"].get("stream.rounds"):
        return None
    return ms / rounds
