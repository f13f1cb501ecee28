"""The PyTorch wavefront window scan against the Pallas kernel.

wavefront_tables_ref (rafft_tpu_torch) must reproduce the Pallas kernel
(rafft_tpu.engine.wavefront, run through the Pallas interpreter as
tests/test_wavefront.py runs it) entry for entry over whole [K, R, 2N]
tables, padding cells and zeroed tail included.  All tables are exact
(integers, and f32 sums of small integers), so comparisons are exact.
The CUDA kernel is held against wavefront_tables_ref on the card.
"""

import numpy as np
import pytest
import torch

from rafft_tpu.engine.wavefront import wavefront_tables as pallas_tables
from rafft_tpu_torch.energy.eval_torch import device_params
from rafft_tpu_torch.engine import wavefront as WT
from tests.test_wavefront import CFG, DP, W, _Z1, _random_regions, _zrows

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

DPT = device_params(37.0, CFG.N, "cpu")


def _degenerate():
    """Empty regions, single positions, a full contiguous region, and a
    beam row whose regions are all empty (mlen 0)."""
    K, R, N = CFG.K, CFG.R, CFG.N
    rpos = np.full((K, R, N), N, dtype=np.int32)
    rcodes = np.zeros((K, R, N), dtype=np.int32)
    mlen = np.zeros((K, R), dtype=np.int32)
    codes = np.random.default_rng(7).integers(0, 4, size=80)
    rpos[0, 0, :80] = np.arange(80)
    rcodes[0, 0, :80] = codes
    mlen[0, 0] = 80
    rpos[0, 1, 0] = 5
    rcodes[0, 1, 0] = 2
    mlen[0, 1] = 1
    rpos[0, 2, :2] = [10, 11]
    rcodes[0, 2, :2] = [1, 2]
    mlen[0, 2] = 2
    return rcodes, rpos, mlen          # beam row 1: every region empty


def _layout(case):
    if case == "degenerate":
        rc, rp, ml = _degenerate()
    else:
        rc, rp, ml = (np.asarray(x) for x in
                      _random_regions(np.random.default_rng(int(case[-1]))))
    z1, z2 = (np.asarray(z) for z in _zrows(rp))
    return rc, rp, ml, z1, z2


def _port(arrays, fn=WT.wavefront_tables, device="cpu"):
    t = [torch.as_tensor(np.array(x), device=device) for x in arrays]
    return fn(CFG, device_params(37.0, CFG.N, device), W, *t)


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "degenerate"])
def test_ref_matches_pallas_whole_tables(case):
    rc, rp, ml, z1, z2 = _layout(case)
    want = pallas_tables(CFG, DP, W, rc, rp, ml, z1row=z1, z2row=z2,
                         interpret=True)
    launches = WT.LAUNCHES
    got = _port((rc, rp, ml, z1, z2))
    assert WT.LAUNCHES == launches       # CPU tensors take the plain version
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == (torch.float32 if k == "cor_raw" else torch.int32)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    if case == "degenerate":
        assert not got["max_nb"][1].any() and not got["cor_raw"][1].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_ref_hash_deltas_brute_force(seed):
    """hd1 at every populated lag equals the sum over the winning stem's
    pairs of Z1[p5](p3+1) + Z1[p3](p5+1) mod 2^32."""
    rc, rp, ml, z1, z2 = _layout(f"seed{seed}")
    tabs = _port((rc, rp, ml, z1, z2))
    nb, mi, mj = (tabs[k].numpy() for k in ("max_nb", "max_i", "max_j"))
    hd1 = tabs["hd1"].numpy().astype(np.uint32)
    kk, rr, ll = np.nonzero(nb > 0)
    assert len(kk) > 50
    for k, r, lag in list(zip(kk, rr, ll))[::max(1, len(kk) // 60)]:
        acc = 0
        for t in range(nb[k, r, lag]):
            p5 = int(rp[k, r, mi[k, r, lag] - t])
            p3 = int(rp[k, r, mj[k, r, lag] + t])
            acc = (acc + int(_Z1[p5]) * (p3 + 1)
                   + int(_Z1[p3]) * (p5 + 1)) & 0xFFFFFFFF
        assert acc == int(hd1[k, r, lag]), (k, r, lag)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "degenerate"])
def test_cuda_kernel_matches_ref(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    arrays = _layout(case)
    want = _port(arrays, fn=WT.wavefront_tables_ref, device="cuda")
    launches = WT.LAUNCHES
    got = _port(arrays, device="cuda")
    torch.cuda.synchronize()
    assert WT.LAUNCHES == launches + 1
    for k in want:
        assert torch.equal(got[k], want[k]), k
