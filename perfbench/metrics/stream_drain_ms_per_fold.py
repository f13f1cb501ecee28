"""stream_drain_ms_per_fold: host ms in run_stream's drain between
replays, in the program's spans engine.rows (each fold's rows),
stream.encode and stream.load, per fold answered in a traced stream run
(the inside twin of stream_host_ms_per_fold)."""

from perfbench.program_trace import stream_ms_per


def read(ctx):
    return stream_ms_per(ctx, ("engine.rows", "stream.encode", "stream.load"),
                         "stream.folds")
