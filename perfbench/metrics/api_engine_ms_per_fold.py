"""api_engine_ms_per_fold: host ms over the traced window in the engine a
fold() call builds (FoldEngine.__init__ and FoldEngine._capture: the
eager warm-up round and the graph's capture), per call."""

from perfbench.metrics import host_ms_per


def read(ctx):
    return host_ms_per(ctx, "fold_api", ("__init__", "_capture"), "calls")
