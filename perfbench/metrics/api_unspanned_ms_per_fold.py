"""api_unspanned_ms_per_fold: host ms of fold() calls outside every span
of the program (the self time of its span fold.call) per call of a
traced fold_api run.  With api_build, api_warmup, api_capture,
api_structures and run()'s steps (the spans engine.copy_in, engine.launch
and engine.read, which no metric reads: under the CUDA profiler of the
traced slice their host time is mostly the profiler's) it adds up to the
mean fold.call."""

from perfbench.program_trace import api_ms_per_fold


def read(ctx):
    return api_ms_per_fold(ctx, ("fold.call",), key="self_s")
