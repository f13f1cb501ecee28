"""step_kernels_per_round: kernels the fold step's CUDA graph launched in
the profiled slice, per round replayed there: a count that repeats."""


def read(ctx):
    s, rounds = ctx.get("slice"), ctx.get("rounds")
    if ctx.get("driver") != "stream" or s is None or not rounds \
            or not s.graph_kernels:
        return None
    return s.graph_kernels / rounds
