"""step_device_ms_per_round: device ms of the kernels the fold step's
CUDA graph launched in the profiled slice, per round replayed there
(replays x G).  A replay runs every kernel of its rounds, idle ones
included."""


def read(ctx):
    s, rounds = ctx.get("slice"), ctx.get("rounds")
    if ctx.get("driver") != "stream" or s is None or not rounds \
            or not s.graph_kernels:
        return None
    return 1e3 * s.graph_kernel_s / rounds
