"""stream_host_ms_per_fold: host ms over the traced window in
run_stream's host loop (the engine's _rows_from, _encode and _drain_load
calls), per fold answered."""

from perfbench.metrics import host_ms_per


def read(ctx):
    return host_ms_per(ctx, "stream", ("_rows_from", "_encode", "_drain_load"),
                       "folds")
