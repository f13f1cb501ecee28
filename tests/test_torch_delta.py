"""The fold step's stage delta (engine/delta.py): the wrapper, its checks,
the kernel's view of the energy tables, and on a card the kernel
csrc/delta.cu against the plain version on every lane.

The CPU tests hold the wrapper to the plain version _candidate_delta
(which tests/test_torch_graph_step.py and the parity tests hold to the
JAX engine), its argument checks and kernel_header.  The tests marked
`cuda` compare the kernel with the plain version, all four outputs on
every lane, on the inputs of real fold steps at the shapes the main path
runs, and skip without a card.  This file imports no JAX, so it runs on
the card's machine (tests/conftest.py imports JAX: leave it out there):

    python -m pytest --noconftest tests/test_torch_delta.py -m cuda
"""

import numpy as np
import pytest
import torch

from rafft_tpu_torch.energy.eval_torch import TABLES, device_params
from rafft_tpu_torch.engine import delta as DL
from rafft_tpu_torch.engine import fold_torch as FT
from rafft_tpu_torch.engine.fold_torch import (EngineConfig, FoldEngine,
                                               fold_one_config)
from rafft_tpu_torch.parallel.sweep import bucket_config
from rafft_tpu_torch.tools.corpus import corpus, journal
from rafft_tpu_torch.tools.measure import capture_calls, step_calls

# a small engine that folds quickly on the CPU
CFG_CPU = EngineConfig(N=32, K=5, R=8, M=40, V=64, W=4, CPLX=64, S=256,
                       max_branch=64, max_steps=8)
SEQS_CPU = ["GGGAAACCCAUGCAUGGGAAACCC", "GCGCAAAAGCGCAUAUGGGGAAAACCCCA",
            "ACGUACGUUUGCAAAGC"]


def _random(seed, count, lo, hi):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGU"), int(rng.integers(lo, hi + 1))))
            for _ in range(count)]


def _step_args(cfg, B, seqs, device, steps):
    """The engine and candidate_delta's arguments at each of the first
    `steps` fold steps of `seqs`, run eagerly."""
    eng = FoldEngine(cfg, B=B, device=device, graphs=False)
    return eng, step_calls("candidate_delta", eng, seqs, steps)


def _many_children_args(device):
    """candidate_delta's arguments on a hand-built parent whose exterior
    loop has 55 children: 55 hairpins GAAAC, each followed by a G or a C
    (the exterior region's 55 positions, each a gap from the next), at
    N=512, K=1, R=16.  Every lane of the exterior region with a run is
    unsupported (more than 48 children); the hairpins' regions (AAA)
    hold no stem."""
    units = 55
    seq = "".join("GAAAC" + "GC"[u % 2] for u in range(units))
    pt = np.full(512, -1, np.int32)
    for u in range(units):
        pt[6 * u], pt[6 * u + 4] = 6 * u + 4, 6 * u
    cfg = EngineConfig(N=512, K=1, R=16, M=100, V=64, W=4, CPLX=64, S=256)
    eng = FoldEngine(cfg, B=1, device=device, graphs=False)
    st = eng.init_state([seq])
    st["pt"] = torch.as_tensor(pt[None, None], device=eng.device)
    st["active"] = torch.ones((1, 1), dtype=torch.bool, device=eng.device)
    loops = FT.analyze_pt(eng.dp, st["codes"], st["pt"][:, 0], st["n"])
    st["energy"] = loops["energy"][:, None].to(torch.int32)
    # the exterior loop, then the first 15 hairpins
    ror = np.array([-1] + [6 * u for u in range(cfg.R - 1)], np.int32)
    st["rorder"] = torch.as_tensor(ror[None, None], device=eng.device)
    return capture_calls("candidate_delta", lambda: eng.candidates(st))[0]


def _same(got, want, what):
    for name, g, w in zip(DL.OUT_KEYS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].tolist()
            raise AssertionError(f"{what}: {name} differs at {bad}")


# ----------------------------------------------------------------------
# CPU
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_steps():
    return _step_args(CFG_CPU, 3, SEQS_CPU, "cpu", 3)


def test_wrapper_on_cpu_is_the_plain_version(cpu_steps):
    _, calls = cpu_steps
    assert len(calls) == 3
    before = DL.LAUNCHES
    for i, args in enumerate(calls):
        _same(DL.candidate_delta(*args), DL._candidate_delta(*args),
              f"step {i + 1}")
    assert DL.LAUNCHES == before


def test_fold_torch_keeps_the_plain_version_importable():
    assert FT._candidate_delta is DL._candidate_delta
    assert FT._children is DL._children
    assert FT.candidate_delta is DL.candidate_delta


def test_many_children_make_every_exterior_stem_unsupported():
    args = _many_children_args("cpu")
    rorder = args[7]
    delta, unsup, has, p0 = DL.candidate_delta(*args)
    _same((delta, unsup, has, p0), DL._candidate_delta(*args), "55 children")
    ext = (rorder[0, 0] == -1).nonzero()[0, 0]
    assert has[0, 0, ext].any()
    assert torch.equal(unsup[0, 0, ext], has[0, 0, ext])
    assert not delta[0, 0, ext].any()


def _cpu_args(cpu_steps):
    eng, calls = cpu_steps
    return eng, list(calls[-1])


def _as_kw(args):
    cfg, dp, codes, n, keys, pt, loops, rorder, rpos, ws = args
    return dict(cfg=cfg, dp=dp, codes=codes, n=n, keys=keys, pt=pt,
                loops=loops, rorder=rorder, rpos=rpos, ws=ws)


def _noncontig(x):
    y = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not y.is_contiguous() or x.shape[-1] == 1
    return y


# each fault: a name and a function of the keyword arguments that breaks one
FAULTS = {
    "codes_int64": lambda a: a.update(codes=a["codes"].long()),
    "n_shape": lambda a: a.update(n=a["n"][:1]),
    "two_keys": lambda a: a.update(keys=a["keys"][:2]),
    "key_float": lambda a: a.update(keys=[a["keys"][0].float(),
                                          *a["keys"][1:]]),
    "pt_noncontig": lambda a: a.update(pt=_noncontig(a["pt"])),
    "rorder_int64": lambda a: a.update(rorder=a["rorder"].long()),
    "rpos_noncontig": lambda a: a.update(rpos=_noncontig(a["rpos"])),
    "is_open_int32": lambda a: a.update(loops=dict(
        a["loops"], is_open=a["loops"]["is_open"].to(torch.int32))),
    "enclose_shape": lambda a: a.update(loops=dict(
        a["loops"], enclose=a["loops"]["enclose"][:, :1])),
    "ws_short_lag_axis": lambda a: a.update(ws=dict(
        a["ws"], max_j=a["ws"]["max_j"][..., 1:].contiguous())),
    "ws_noncontig": lambda a: a.update(ws=dict(
        a["ws"], best_sE=_noncontig(a["ws"]["best_sE"]))),
    "n_other_than_cfg": lambda a: a.update(
        cfg=EngineConfig(N=64, K=5, R=8, M=40)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_check_args_refuses(cpu_steps, fault):
    _, args = _cpu_args(cpu_steps)
    kw = _as_kw(args)
    DL._check_args(C=48, **kw)
    FAULTS[fault](kw)
    with pytest.raises(ValueError):
        DL._check_args(C=48, **kw)


class _Bent:
    """DeviceParams `dp` with table `name` replaced by fn(table)."""

    def __init__(self, dp, name, fn):
        self.dp, self.name, self.fn = dp, name, fn

    def __getattr__(self, k):
        v = getattr(self.dp, k)
        return self.fn(v) if k == self.name else v


def test_check_args_refuses_c_and_tables(cpu_steps):
    _, args = _cpu_args(cpu_steps)
    kw = _as_kw(args)
    for C in (0, DL.C_MAX + 1):
        with pytest.raises(ValueError, match="C="):
            DL._check_args(C=C, **kw)
    for name, fn in (("stack", torch.Tensor.long),
                     ("hexa", lambda t: t[::2]),
                     ("int22", lambda t: t.transpose(-1, -2))):
        kw["dp"] = _Bent(args[1], name, fn)
        with pytest.raises(ValueError, match=name):
            DL._check_args(C=48, **kw)


def test_wrapper_refuses_other_devices(cpu_steps):
    _, args = _cpu_args(cpu_steps)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        DL.candidate_delta(*meta)


def test_replays_count():
    before = DL.LAUNCHES
    DL.KERNEL.count_replay(4)
    assert DL.LAUNCHES == before + 4
    DL.LAUNCHES = before


def test_delta_work_counts_the_bytes():
    w = DL.delta_work((16, 200, 16, 200), 128, 1000)
    lanes = 16 * 200 * 16 * 200
    assert w["lanes"] == lanes and w["regions"] == 16 * 200 * 16
    reads = (16 * lanes + 16 * 200 * 16 * 128 * 4 + 16 * 200 * 128 * 25
             + 16 * 128 * 16 + 16 * 4 + 16 * 200 * 16 * 4 + 4000)
    assert w["bytes"] == reads + 10 * lanes


@pytest.mark.parametrize("N", [32, 128, 4096])
def test_kernel_header_reads_the_tables(N):
    dp = device_params(37.0, N, "cpu")
    head = dict(zip(DL.HEADER, DL.kernel_header(dp)))
    assert list(head) == list(DL.HEADER) and len(head) == 11
    for name in DL.LENGTHS:
        assert head[f"len.{name}"] == getattr(dp, name).shape[0]
    for name in DL.SCALARS:
        assert head[name] == getattr(dp, name)
    # every multi-dimensional table, as the kernel indexes it: a flat
    # row-major index over SHAPES, on random indices and both corners
    rng = np.random.default_rng(N)
    for name, shape in DL.SHAPES.items():
        tab = getattr(dp, name)
        assert tab.is_contiguous() and tab.dtype == torch.int32
        idx = [np.concatenate([rng.integers(0, d, 500), [0, d - 1]])
               for d in shape]
        lin = np.ravel_multi_index(idx, shape)
        flat = idx[0]
        for d, i in zip(shape[1:], idx[1:]):
            flat = flat * d + i
        assert (flat == lin).all()
        assert torch.equal(tab.reshape(-1)[torch.as_tensor(flat)],
                           tab[tuple(torch.as_tensor(i) for i in idx)]), name


def test_kernel_header_refuses_other_shapes():
    dp = device_params(37.0, 32, "cpu")
    with pytest.raises(ValueError, match="int11"):
        DL.kernel_header(_Bent(dp, "int11", lambda t: t[:4]))
    with pytest.raises(ValueError, match="internal"):
        DL.kernel_header(_Bent(dp, "internal", lambda t: t[:5]))


# ----------------------------------------------------------------------
# card
# ----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the delta kernel has no CPU mode")
    return torch.device("cuda")


def _rows(lo, hi, count):
    return [r["seq"] for r in journal() if lo <= len(r["seq"]) <= hi][:count]


def _longest():
    return max((s for s, _ in corpus()), key=len)


# case: (configuration, B, sequences, steps)
CASES = {
    "n128_k200_m200": (lambda: (bucket_config(128, 200, 200, 1000), 16,
                                _rows(65, 128, 16), 4)),
    "n128_k50_m100": (lambda: (bucket_config(128, 100, 50, 1000), 16,
                               _rows(65, 128, 16), 4)),
    "n512_k50_m100_r24": (lambda: (bucket_config(512, 100, 50, 1000), 8,
                                   _rows(257, 512, 8), 4)),
    "api_b1_k20": (lambda: (fold_one_config(len(_rows(65, 128, 1)[0]), 100,
                                            20, 1000), 1, _rows(65, 128, 1),
                            6)),
    "n32_m63": (lambda: (bucket_config(32, 100, 50, 1000), 16,
                         _random(32, 16, 18, 32), 4)),
    "n4096_r32": (lambda: (bucket_config(4096, 100, 50, 1000), 1,
                           [_longest()], 3)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_plain_on_real_steps(card, case):
    cfg, B, seqs, steps = CASES[case]()
    eng, calls = _step_args(cfg, B, seqs, card, steps)
    assert len(calls) == steps
    unsup = empty = 0
    for i, args in enumerate(calls):
        before = DL.LAUNCHES
        got = DL.candidate_delta(*args)
        torch.cuda.synchronize()
        assert DL.LAUNCHES == before + 1
        want = DL._candidate_delta(*args)
        _same(got, want, f"{case} step {i + 1}")
        unsup += int((want[1] & want[2]).sum())
        empty += int((args[7] == -2).sum())
    # the steps hold unsupported stems (at these widths: stems that jump
    # an excised gap) and empty region slots
    assert unsup > 0 and empty > 0, (unsup, empty)


@pytest.mark.cuda
def test_kernel_flags_regions_of_many_children(card):
    args = _many_children_args(card)
    got = DL.candidate_delta(*args)
    want = DL._candidate_delta(*args)
    _same(got, want, "55 children")
    ext = (args[7][0, 0] == -1).nonzero()[0, 0]
    assert got[2][0, 0, ext].any()
    assert torch.equal(got[1][0, 0, ext], got[2][0, 0, ext])


@pytest.mark.cuda
def test_kernel_refuses_before_any_launch(card):
    cfg = bucket_config(32, 100, 50, 1000)
    _, calls = _step_args(cfg, 4, _random(7, 4, 18, 32), card, 1)
    args = list(calls[0])
    before = DL.LAUNCHES
    bad = dict(args[9], max_i=args[9]["max_i"].long())
    with pytest.raises(ValueError, match="max_i"):
        DL.candidate_delta(*args[:9], bad)
    with pytest.raises(ValueError, match="contiguous"):
        DL.candidate_delta(*args[:8], _noncontig(args[8]), args[9])
    assert DL.LAUNCHES == before


@pytest.mark.cuda
def test_graphed_step_counts_the_kernel(card):
    cfg = bucket_config(32, 100, 50, 1000)
    eng = FoldEngine(cfg, B=4, device=card)
    before = DL.LAUNCHES
    list(eng.run_stream(_random(9, 6, 18, 32), G=4))
    assert DL.CAPTURED > 0 and DL.LAUNCHES > before
