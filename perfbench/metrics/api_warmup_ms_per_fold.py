"""api_warmup_ms_per_fold: host ms in the program's span engine.warmup (the
eager round before a graph's capture, launched op by op) per fold() call
of a traced fold_api run."""

from perfbench.program_trace import api_ms_per_fold


def read(ctx):
    return api_ms_per_fold(ctx, ("engine.warmup",))
