"""The port's batched MFE DP (rafft_tpu_torch.mfe) against the JAX DP and
the native C++ DP, on the CPU.

Everything on this path is int32 dekacal, so every comparison is exact
(tolerance 0): whole matrices Cd, Md, F and the energies E against
mfe_jax._mfe_fill, structures and energies against mfe_jax.mfe_batch and
the native DP.  Two JAX compiles: _mfe_fill at N=32, B=4 and at N=64, B=8
(mfe_batch on the same 8 sequences reuses the second).
"""

import numpy as np
import pytest
import torch

from rafft_tpu.mfe import mfe_fold as jax_native_mfe_fold
from rafft_tpu.mfe import mfe_jax as MJ
from rafft_tpu_torch.energy import eval_torch as ET
from rafft_tpu_torch.energy.eval_np import eval_structure_int
from rafft_tpu_torch.energy.params import encode_sequence
from rafft_tpu_torch.mfe import mfe_fold, mfe_fold_pt
from rafft_tpu_torch.mfe import mfe_torch as MT

torch.set_num_threads(1)


def _seqs(seed, count, nmin, nmax):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGU"), int(rng.integers(nmin, nmax + 1))))
            for _ in range(count)]


# N=32, B=4: a full row, two padded rows and one under 5 nt
SEQS32 = _seqs(11, 1, 32, 32) + _seqs(12, 2, 9, 28) + ["GCAU"]
# N=64, B=8: rows of 15 to 64 nt
SEQS64 = _seqs(13, 8, 15, 64)


def _batch(seqs, N):
    codes = np.zeros((len(seqs), N), np.int32)
    n = np.zeros(len(seqs), np.int32)
    for b, s in enumerate(seqs):
        c = encode_sequence(s)
        codes[b, :len(c)] = c
        n[b] = len(c)
    return codes, n


@pytest.fixture(scope="module", params=[32, 64])
def fills(request):
    """(sequences, JAX matrices, port matrices) at one N."""
    N = request.param
    seqs = SEQS32 if N == 32 else SEQS64
    codes, n = _batch(seqs, N)
    want = [np.asarray(x) for x in MJ._mfe_fill(MJ._dp_dict(37.0, N), codes, n)]
    got = MT._mfe_fill(ET.device_params(37.0, N, "cpu"),
                       torch.as_tensor(codes), torch.as_tensor(n))
    return seqs, want, [x.numpy() for x in got]


def test_ab_pairs_equal():
    a, b = MT._ab_pairs()
    ja, jb = MJ._ab_pairs()
    assert a.dtype == np.int32 and len(a) == 496
    assert np.array_equal(a, ja) and np.array_equal(b, jb)
    assert MT.INF == int(MJ.INF) and MT.MAXLOOP == MJ.MAXLOOP


def _seeded_md(rng, N, low):
    md = rng.integers(low, 3000, (N, N)).astype(np.int32)
    md[rng.random((N, N)) < 0.3] = MT.INF
    return md


def _real(x):
    """INF for a value within 2^20 of INF: a sum of INF and a negative
    entry (see mfe_torch._skew_min), never a finite candidate."""
    return np.where(x < MT.INF - (1 << 20), x, MT.INF)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("d", [0, 8, 9, 13, 20, 31])
def test_skew_min_equal(signed, shift, d):
    """Exact on non-negative entries; with negative entries equal
    wherever the JAX result is a sum of two finite entries or INF."""
    N = 32
    rng = np.random.default_rng(100 * shift + d)
    mds = [_seeded_md(rng, N, -400 if signed else 0) for _ in range(3)]
    want = np.stack([np.asarray(MJ._skew_min(m, d, shift)) for m in mds])
    if signed:
        want = _real(want)
    norm = _real if signed else (lambda x: x)
    batched = MT._skew_min(torch.as_tensor(np.stack(mds)), d, shift)
    assert batched.dtype == torch.int32
    assert np.array_equal(norm(batched.numpy()), want)
    # one matrix, no batch dims; and the first L columns alone
    one = MT._skew_min(torch.as_tensor(mds[0]), d, shift).numpy()
    assert np.array_equal(norm(one), want[0])
    L = max(N - d, 1)
    part = MT._skew_min(torch.as_tensor(np.stack(mds)), d, shift, L)
    assert np.array_equal(norm(part.numpy()), want[:, :L])
    if signed and d >= 13:
        # the seeded entries do make such sums in the JAX function
        raw = np.asarray(MJ._skew_min(mds[0], d, shift))
        assert ((raw < MT.INF) & (raw >= MT.INF - (1 << 20))).any()


@pytest.mark.parametrize("k, name", enumerate(["Cd", "Md", "F", "E"]))
def test_mfe_fill_equals_jax(fills, k, name):
    seqs, want, got = fills
    assert got[k].dtype == np.int32, name
    assert got[k].shape == want[k].shape, name
    assert np.array_equal(got[k], want[k]), (
        name, np.argwhere(got[k] != want[k])[:5].tolist())


def test_mfe_fill_reads_the_device_once():
    """No host read inside the diagonal and F loops: the one read is the
    longest row's length, before them."""
    seqs = SEQS32
    codes, n = _batch(seqs, 32)
    reads = []
    orig = {k: getattr(torch.Tensor, k) for k in ("__bool__", "__int__",
                                                  "item", "tolist")}

    def counting(name):
        def f(self, *a):
            reads.append(name)
            return orig[name](self, *a)
        return f

    dp = ET.device_params(37.0, 32, "cpu")
    for k in orig:
        setattr(torch.Tensor, k, counting(k))
    try:
        MT._mfe_fill(dp, torch.as_tensor(codes), torch.as_tensor(n))
        assert reads == ["__int__"], reads
        # MfeEngine knows the longest row: no read at all
        reads.clear()
        MT.MfeEngine(32, B=4, device="cpu").fill(seqs)
        assert reads == [], reads
    finally:
        for k, f in orig.items():
            setattr(torch.Tensor, k, f)


def test_engine_equals_jax_and_native():
    eng = MT.MfeEngine(64, B=8, device="cpu")
    got = eng.fold(SEQS64)
    want = MJ.mfe_batch(SEQS64, N=64)
    assert got == want
    for s, (db, e) in zip(SEQS64, got):
        assert (db, e) == mfe_fold(s), s
        # the traced structure re-evaluates to the DP energy
        assert eval_structure_int(s, db) == round(e * 100), s
    assert [e for _, e in eng.fold(SEQS64, structures=False)] == \
        [e for _, e in got]


def test_mfe_batch_buckets_and_pads():
    seqs = SEQS32[1:3]
    got = MT.mfe_batch(seqs, device="cpu")          # N = 32 from the lengths
    assert got == [mfe_fold(s) for s in seqs]
    eng = MT.MfeEngine(32, B=4, device="cpu")
    assert eng.fold(seqs) == got
    with pytest.raises(ValueError):
        eng.fold(SEQS32 + SEQS32[:1])
    with pytest.raises(ValueError):
        eng.fold(["A" * 33])


@pytest.mark.parametrize("temp", [37.0, 25.0])
def test_mfe_fold_equals_jax_package(temp):
    """The port's native DP against rafft_tpu.mfe.mfe_fold (the JAX
    package's native DP) on 25 seeded sequences of 20-90 nt."""
    rng = np.random.default_rng(7)
    for _ in range(25):
        seq = "".join(rng.choice(list("ACGU"), int(rng.integers(20, 90))))
        db, e = mfe_fold(seq, temp)
        assert (db, e) == jax_native_mfe_fold(seq, temp), seq
        pt, ei = mfe_fold_pt(seq, temp)
        assert pt.dtype == np.int32 and round(e * 100) == ei


def test_engine_at_25_degrees_equals_native():
    seqs = SEQS32[:3]
    got = MT.MfeEngine(32, temperature=25.0, B=3, device="cpu").fold(seqs)
    assert got == [mfe_fold(s, 25.0) for s in seqs]
    assert got != [mfe_fold(s, 37.0) for s in seqs]


def test_traced_structures_reevaluate():
    for seq in _seqs(21, 10, 20, 90):
        db, e = mfe_fold(seq)
        assert eval_structure_int(seq, db) == round(e * 100), seq


def test_tiny_sequences():
    tiny = ["A", "ACGU", "AAAAA"]
    for seq in tiny:
        assert mfe_fold(seq) == ("." * len(seq), 0.0)
    assert MT.MfeEngine(32, B=4, device="cpu").fold(tiny) == \
        [("." * len(s), 0.0) for s in tiny]
