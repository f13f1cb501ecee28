"""The benchmark's frozen copies equal what they were copied from: the
wavefront kernel's work arithmetic, and the reference fold (against the
port's sequential CPU engine, which the reference must not import)."""

import numpy as np
import pytest

from perfbench import check, traffic, work


@pytest.mark.parametrize("N", [64, 128, 1024])
def test_frozen_wavefront_work_equals_the_ports(N):
    import torch

    from rafft_tpu_torch.engine.wavefront import wavefront_work
    from rafft_tpu_torch.tools.measure import kernel_bound
    rng = np.random.default_rng(N)
    for shape in ((16, 50, 16), (4, 200, 32), (3,)):
        mlen = rng.integers(0, N + 1, shape)
        mlen[..., 0] = 0
        mine = work.wavefront_work(mlen, N)
        assert mine == wavefront_work(torch.as_tensor(mlen, dtype=torch.int32), N)
        assert work.least_seconds(mine) * 1e3 == pytest.approx(
            kernel_bound(mine)[0], rel=1e-12)


SETTINGS = dict(nb_mode=30, max_stack=5, max_branch=100, min_hp=3,
                min_nrj=0.0, temp=37.0, gc_wei=3.0, au_wei=2.0, gu_wei=1.0)


@pytest.mark.parametrize("traj", [False, True])
def test_the_reference_fold_equals_the_ports_cpu_engine(traj):
    from rafft_tpu_torch.engine import fold_cpu
    seqs = traffic.band(33, 70)[:3]
    settings = dict(SETTINGS, traj=traj)
    form = "trajectory" if traj else "rows"
    expected = check.reference_answers(seqs, settings, form, workers=2)
    for seq, exp in zip(seqs, expected):
        kw = {k: v for k, v in settings.items() if k != "traj"}
        out = fold_cpu.fold(seq, traj=traj, **kw)
        got = (check.canon_trajectory(*out) if traj else
               check.canon_rows([(s.str_struct, s.energy) for s in out]))
        assert got == exp
