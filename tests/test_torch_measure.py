"""The host-side parts of the port's measurement script, on the CPU.

rafft_tpu_torch/tools/measure.py runs on a CUDA card; what it computes on
the host (the row selection per bucket, the random nested tables it
feeds the loop analysis, and the reading of a profiler trace) is checked
here.
"""

import json

import numpy as np
import pytest

from rafft_tpu_torch.tools import measure as MS


@pytest.mark.parametrize("N,count,flagged", [(256, 32, []),
                                             (512, 16, [2268, 2269]),
                                             (1024, 4, [2293])])
def test_bucket_rows(N, count, flagged):
    rows = MS.journal()
    sel = MS.bucket_rows(rows, N, count)
    index = {id(r): i for i, r in enumerate(rows)}
    got = [index[id(r)] for r in sel]
    first = {256: 1938, 512: 2018, 1024: 2270}[N]
    assert got == list(range(first, first + count)) + flagged
    assert all(N // 2 < len(r["seq"]) <= N for r in sel)


def test_nested_tables_valid():
    codes, pt, n = MS.nested_tables(np.random.default_rng(7), 16, 256, 129, 256)
    pairs = {(1, 4), (4, 1), (2, 3), (3, 2), (3, 4), (4, 3)}
    for b in range(16):
        assert 129 <= n[b] <= 256
        assert (pt[b, n[b]:] == -1).all() and (codes[b, n[b]:] == 0).all()
        stack = []
        for i in range(n[b]):
            j = pt[b, i]
            if j < 0:
                continue
            assert pt[b, j] == i and (codes[b, min(i, j)],
                                      codes[b, max(i, j)]) in pairs
            if j > i:
                stack.append(i)
            else:
                assert stack.pop() == j and i - j > 3
        assert not stack
    assert (pt >= 0).sum() > 0


def test_trace_stats(tmp_path):
    """Kernels count toward the stage whose host range holds their
    launch; kernels launched outside every range count only in the
    total."""
    ev = []

    def kernel(corr, launch_ts, dur):
        ev.append(dict(cat="cuda_runtime", name="cudaLaunchKernel",
                       ts=launch_ts, dur=1, args=dict(correlation=corr)))
        ev.append(dict(cat="kernel", name="k", ts=launch_ts + 50, dur=dur,
                       args=dict(correlation=corr)))

    ev.append(dict(cat="user_annotation", name="stage:eval_pt", ts=100,
                   dur=100))
    ev.append(dict(cat="user_annotation", name="stage:eval_pt", ts=400,
                   dur=50))
    ev.append(dict(cat="user_annotation", name="stage:_regions", ts=1000,
                   dur=10))
    kernel(1, 120, 2000)       # eval_pt
    kernel(2, 410, 3000)       # eval_pt, second range
    kernel(3, 300, 4000)       # between the ranges: no stage
    kernel(4, 1005, 1000)      # _regions
    ev.append(dict(cat="gpu_memcpy", name="m", ts=2000, dur=500,
                   args=dict(correlation=5)))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(dict(traceEvents=ev)))
    kms, nops, stages = MS._trace_stats(str(path))
    assert nops == 5
    assert kms == pytest.approx(10.5)
    assert stages["eval_pt"] == pytest.approx((5.0, 0.15, 2))
    assert stages["_regions"] == pytest.approx((1.0, 0.01, 1))
    assert set(stages) == {"eval_pt", "_regions"}
