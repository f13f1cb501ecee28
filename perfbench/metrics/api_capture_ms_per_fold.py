"""api_capture_ms_per_fold: host ms in the program's span engine.capture
(the fold step's CUDA graph capture) per fold() call of a traced
fold_api run."""

from perfbench.program_trace import api_ms_per_fold


def read(ctx):
    return api_ms_per_fold(ctx, ("engine.capture",))
