"""api_build_ms_per_fold: host ms in the program's span engine.build (the
engine a call builds, FoldEngine.__init__) per fold() call of a traced
fold_api run."""

from perfbench.program_trace import api_ms_per_fold


def read(ctx):
    return api_ms_per_fold(ctx, ("engine.build",))
