"""api_traj_ms_per_fold: host ms over the traced window in the
trajectory's read (FoldEngine._structures, once a step and once at the
end), per fold() call."""

from perfbench.metrics import host_ms_per


def read(ctx):
    return host_ms_per(ctx, "fold_api", ("_structures",), "calls")
