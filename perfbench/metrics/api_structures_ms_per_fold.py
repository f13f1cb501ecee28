"""api_structures_ms_per_fold: host ms in the program's span
engine.structures (FoldEngine._structures: the trajectory's beams and the
final beam read off the card) per fold() call of a traced fold_api run
(the inside twin of api_traj_ms_per_fold)."""

from perfbench.program_trace import api_ms_per_fold


def read(ctx):
    return api_ms_per_fold(ctx, ("engine.structures",))
