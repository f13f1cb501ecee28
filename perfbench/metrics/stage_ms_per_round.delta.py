"""stage_ms_per_round.delta: device ms of the fold step's stage "delta" per
round replayed in the traced slice of a stream run: the time between the
timing events that the step's CUDA graph records at the stage's
boundaries (rafft_tpu_torch/obs.py), summed over the slice's replays."""

from perfbench.program_trace import stage_ms_per_round


def read(ctx):
    return stage_ms_per_round(ctx, "delta")
