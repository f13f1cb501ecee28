"""Anti-diagonal wavefront window scan: plain PyTorch and the CUDA kernel.

Counterpart of rafft_tpu/engine/wavefront.py.  For every region of the
region-local pair matrix (ip, jp), the reference's window-slide
recurrence depends only on the previous cell of the same anti-diagonal
lag = ip + jp, namely (ip-1, jp+1); the raw correlation is the running
sum of pair weights along the same diagonal.

Every function here returns, per lag, the same seven [..., R, 2N] tables
as the Pallas kernel, entry for entry over the whole table, padding
entries and zeroed tail included.

* wavefront_tables_ref is the recurrence step by step in plain tensor
  ops, rows ip = 0..mmax-1 with a state vector over jp (the CPU path and
  the kernel's yardstick);
* wavefront_tables_closed is the plain twin of the CUDA kernel's
  algorithm: the recurrence over the region's own m x m cells only, and
  closed forms for every entry that the padding cells decide;
* wavefront_tables launches the hand-written kernel csrc/wavefront.cu
  for CUDA tensors, into tables the caller may allocate once
  (empty_tables), also inside a CUDA graph capture;
* wavefront_work counts the bytes and operations a call needs, for the
  kernel's bound on the card;
* check_layout tells whether a call's tensors keep the layout contract.

The layout contract (what fold_torch._regions produces): a region's m
member positions ascend in rpos[..., :m] and are < N; past them rpos is
N and rcodes is 0; the pair weights of code 0 are 0; min_hp >= 0.  Under
it a padding cell has weight 0, so it resets the run and can only move
(max_i, max_j) of a lag that has met no region cell yet:

* cells with ip >= m never pass the hairpin test (rpos[ip] = N);
* cells with jp >= m pass it iff rpos[ip] < N - min_hp, a prefix
  ip < c of the region because rpos ascends (and, positions being
  distinct, c is m less some of the last min_hp of them), and they
  precede the region's own cells on the diagonal.

So a lag L >= 2m-1 (no region cell) has max_i = c-1, max_j = L-c+1 when
1 <= c and L <= N+c-2, else 0; a lag m <= L <= 2m-2 starts its region
cells from max_i = min(L-m, c-1) (when that is >= L-N+1 and m < N); all
other entries start from 0, and the tables do not depend on the beam
row's longest region.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from rafft_tpu_torch import _build

MASK32 = 0xFFFFFFFF
KEYS = ("cor_raw", "max_nb", "max_i", "max_j", "best_sE", "hd1", "hd2")

# launches of the CUDA kernel, and launches recorded into CUDA graph
# captures (the plain versions do not count; see _build.Kernel)
LAUNCHES = 0
CAPTURED = 0
KERNEL = _build.Kernel("wavefront", __name__, "rafft_wavefront",
                       [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])


class SmallTables(NamedTuple):
    """The lookup tables on one device, flattened: pair weights W f32
    [25], pair types PT int32 [25] (no pair = 7), stack energies ST int32
    [64], and for the CUDA kernel SE int32 [625], the stack energy
    between the pairs of code pairs la and lb at la * 25 + lb:
    ST[PT[la] * 8 + PT[lb]], 0 where either is no pair."""
    W: torch.Tensor
    PT: torch.Tensor
    ST: torch.Tensor
    SE: torch.Tensor


def small_tables(dp, W, device) -> SmallTables:
    """Build the lookup tables once per engine and device (a host-to-
    device copy each: keep it out of the fold step)."""
    Wn = np.asarray(W, np.float32)
    if Wn.shape != (5, 5) or Wn[0].any() or Wn[:, 0].any():
        raise ValueError("pair weights must be [5, 5] with zero weight for "
                         "code 0 (the padding code)")
    PT = dp.pair_type.reshape(-1).to(device=device, dtype=torch.int32)
    PT = torch.where(PT != 0, PT, 7)
    ST = dp.stack.reshape(-1).to(device=device, dtype=torch.int32)
    A, B = PT[:, None].long(), PT[None, :].long()
    SE = torch.where((A <= 6) & (B <= 6), ST[(A * 8 + B).clamp(max=63)], 0)
    return SmallTables(torch.as_tensor(Wn.reshape(-1), device=device),
                       PT.contiguous(), ST.contiguous(),
                       SE.reshape(-1).contiguous())


def _to_i32(x):
    """int64 holding a uint32 pattern -> the same bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _lut(tab, lin, default):
    """tab[lin] where lin is in range and the entry is not 0."""
    ok = (lin >= 0) & (lin < tab.shape[0])
    v = tab[lin.clamp(0, tab.shape[0] - 1).long()]
    return torch.where(ok & (v != 0), v, default)


def wavefront_tables_ref(cfg, tabs, rcodes, rpos, mlen, z1row, z2row):
    """Per-lag window-scan tables in plain PyTorch, step by step.

    tabs is small_tables(...) on the inputs' device; rcodes/rpos/z1row/
    z2row are int32 [..., R, N] (z*row: Z[rpos] as uint32 bit patterns),
    mlen int32 [..., R].  Returns dict(cor_raw f32, max_nb, max_i, max_j,
    best_sE, hd1, hd2 int32), each [..., R, 2N]; hd1/hd2 are uint32 bit
    patterns.  Lag L is finalised at row min(L, mmax-1), where mmax is
    the longest region of the beam row, and lags >= mmax+N-1 are zero."""
    N = rcodes.shape[-1]
    dev = rcodes.device
    Wt, PT, ST, _ = tabs
    i32, f32 = torch.int32, torch.float32
    mmax = mlen.amax(-1)[..., None, None]                  # [..., 1, 1]
    m = mlen[..., None]                                     # [..., R, 1]
    lane = torch.arange(N, dtype=i32, device=dev)
    z1 = z1row.long() & MASK32
    z2 = z2row.long() & MASK32

    def ptype(lin):
        return _lut(PT, lin, 7)

    # constants along the sweep: the jp side of every cell
    c3, p3 = rcodes, rpos
    c3p = F.pad(rcodes[..., 1:], (0, 1), value=0)         # rcodes[jp+1]
    p3p = F.pad(rpos[..., 1:], (0, 1), value=-9)          # rpos[jp+1]

    shape = rcodes.shape
    zf = torch.zeros(shape, dtype=f32, device=dev)
    zi = torch.zeros(shape, dtype=i32, device=dev)
    zl = torch.zeros(shape, dtype=torch.int64, device=dev)
    tot, cor, ms = zf, zf, zf
    tmp, sE, nb, mi, mj, bsE = zi, zi, zi, zi, zi, zi
    hd1, hd2, bh1, bh2 = zl, zl, zl, zl
    out = {k: torch.zeros(shape[:-1] + (2 * N,), dtype=d, device=dev)
           for k, d in zip(KEYS, (f32, i32, i32, i32, i32, torch.int64,
                                  torch.int64))}

    def shift(x):
        # state at (ip-1, jp+1): one lane left, zero fill at jp = N-1
        return F.pad(x[..., 1:], (0, 1), value=0)

    for ip in range(int(mmax.max()) if mmax.numel() else 0):
        c5 = rcodes[..., ip:ip + 1]
        p5 = rpos[..., ip:ip + 1]
        if ip > 0:
            c5m, p5m = rcodes[..., ip - 1:ip], rpos[..., ip - 1:ip]
        else:
            c5m = torch.zeros_like(c5)
            p5m = torch.full_like(p5, -9)
        tot_p, tmp_p, sE_p, cor_p = shift(tot), shift(tmp), shift(sE), shift(cor)
        ms_p, nb_p, mi_p, mj_p = shift(ms), shift(nb), shift(mi), shift(mj)
        bsE_p, hd1_p, hd2_p = shift(bsE), shift(hd1), shift(hd2)
        bh1_p, bh2_p = shift(bh1), shift(bh2)

        lag = lane + ip
        lo = (lag - m + 1).clamp(min=0)
        w = _lut(Wt, c5 * 5 + c3, 0.0)
        contig = (ip > lo) & (p5 - p5m == 1) & (p3p - p3 == 1)
        tot = torch.where(contig, (tot_p + w) * w, w)
        tmp = torch.where(tot == 0, 0, tmp_p + 1)
        # stack energy between outer pair (ip-1, jp+1) and inner (ip, jp)
        A = ptype(c5m * 5 + c3p)
        Bt = ptype(c3 * 5 + c5)
        g = torch.where((A <= 6) & (Bt <= 6), ST[(A * 8 + Bt).long()], 0)
        in_run = (tot != 0) & (tot_p != 0) & contig
        sE = torch.where((tot == 0) | (tot_p == 0), 0,
                         torch.where(in_run, sE_p + g, sE_p))
        # hash delta of pairing (p5, p3): Z[p5]*(p3+1) + Z[p3]*(p5+1), mod 2^32
        z1c = z1[..., ip:ip + 1] * (p3 + 1) + z1 * (p5 + 1)
        z2c = z2[..., ip:ip + 1] * (p3 + 1) + z2 * (p5 + 1)
        hd1 = torch.where(tot == 0, 0, (hd1_p + z1c) & MASK32)
        hd2 = torch.where(tot == 0, 0, (hd2_p + z2c) & MASK32)

        w_width = torch.where(lag < m, lag + 1, 2 * m - lag - 1)
        half = w_width // 2 + w_width % 2                   # floor semantics
        upd = (ip - lo < half) & ((p3 - p5) > cfg.min_hp) & (tot >= ms_p)
        ms = torch.where(upd, tot, ms_p)
        nb = torch.where(upd, tmp, nb_p)
        mi = torch.where(upd, ip, mi_p)
        mj = torch.where(upd, lane, mj_p)
        bsE = torch.where(upd, sE, bsE_p)
        bh1 = torch.where(upd, hd1, bh1_p)
        bh2 = torch.where(upd, hd2, bh2_p)
        cor = cor_p + w

        # lag ip+jp is final here when this is its last row: lane 0
        # (lag == ip) while ip < mmax-1, every lane at ip == mmax-1
        rec = (ip < mmax) & ((lane == 0) | (ip == mmax - 1))
        for k, x in zip(KEYS, (cor, nb, mi, mj, bsE, bh1, bh2)):
            o = out[k][..., ip:ip + N]
            out[k][..., ip:ip + N] = torch.where(rec, x, o)
    out["hd1"] = _to_i32(out["hd1"])
    out["hd2"] = _to_i32(out["hd2"])
    return out


def wavefront_tables_closed(cfg, tabs, rcodes, rpos, mlen, z1row, z2row):
    """The same tables by the CUDA kernel's algorithm, in plain PyTorch.

    Lane t of a region walks lag t (cells ip = 0..t) and then lag t+m
    (cells ip = t+1..m-1), so every lane meets m cells and every lane is
    at row ip = it in iteration it; the window state is only kept up
    while ip - lo < half (the cells the half-window can select), the
    rest of a diagonal adds to the correlation alone.  Entries that
    padding cells decide come from the closed forms in the module note.
    Needs the layout contract stated there."""
    if cfg.min_hp < 0:
        raise ValueError("wavefront tables need min_hp >= 0")
    N = rcodes.shape[-1]
    lead = rcodes.shape[:-1]
    dev = rcodes.device
    Wt, PT, ST, _ = tabs
    i64, f32 = torch.int64, torch.float32
    rc = rcodes.reshape(-1, N).long()
    rp = rpos.reshape(-1, N).long()
    z1 = z1row.reshape(-1, N).long() & MASK32
    z2 = z2row.reshape(-1, N).long() & MASK32
    m = mlen.reshape(-1, 1).long()
    G = rc.shape[0]
    t = torch.arange(N, device=dev)[None, :].expand(G, N)
    # hairpin prefix: the region cells that a padding partner can pair.
    # Positions ascend and are distinct, so only the last min_hp of them
    # can be >= N - min_hp
    c = m.clone()
    for j in range(min(cfg.min_hp, N)):
        x = m - 1 - j
        c -= ((x >= 0) & (rp.gather(1, x.clamp(min=0)) >= N - cfg.min_hp)
              ).long()

    # lags with no region cell
    Lv = torch.arange(2 * N, device=dev)[None, :]
    pad = (c >= 1) & (Lv >= 2 * m - 1) & (Lv <= N + c - 2)
    zero = torch.zeros((G, 2 * N + 1), dtype=i64, device=dev)
    out = {k: zero.clone() for k in KEYS}
    out["cor_raw"] = out["cor_raw"].to(f32)
    out["max_i"][:, : 2 * N] = torch.where(pad, c - 1, 0)
    out["max_j"][:, : 2 * N] = torch.where(pad, Lv - c + 1, 0)

    zf = torch.zeros((G, N), dtype=f32, device=dev)
    zi = torch.zeros((G, N), dtype=i64, device=dev)
    st = dict(tot=zf, tmp=zi, sE=zi, hd1=zi, hd2=zi, cor=zf, ms=zf, nb=zi,
              mi=zi, mj=zi, bsE=zi, bh1=zi, bh2=zi)
    finals = ("cor", "nb", "mi", "mj", "bsE", "bh1", "bh2")
    A = {k: st[k] for k in finals}
    L, lo, half = t, zi, (t + 2) // 2
    c3p, p3p = zi, zi - 9
    for it in range(int(m.max()) if G else 0):
        run = (t < m) & (it < m)
        sw = run & (t + 1 == it)          # lag t is done, lag t+m begins
        if it > 0:
            A = {k: torch.where(sw, st[k], A[k]) for k in finals}
            st = {k: torch.where(sw, 0, v) for k, v in st.items()}
            L = torch.where(sw, t + m, L)
            lo = torch.where(sw, t + 1, lo)
            half = torch.where(sw, (m - t) // 2, half)
            last = torch.minimum(t, c - 1)       # min(L-m, c-1)
            ok = sw & (c >= 1) & (m < N) & (last >= (L - N + 1).clamp(min=0))
            st["mi"] = torch.where(ok, last, st["mi"])
            st["mj"] = torch.where(ok, L - last, st["mj"])
            c3p = torch.where(sw, 0, c3p)
            p3p = torch.where(sw, -9, p3p)
        jp = torch.where(run, L - it, 0)
        c5, p5 = rc[:, it:it + 1], rp[:, it:it + 1]
        if it > 0:
            c5m, p5m = rc[:, it - 1:it], rp[:, it - 1:it]
        else:
            c5m, p5m = torch.zeros_like(c5), torch.full_like(p5, -9)
        c3, p3 = rc.gather(1, jp), rp.gather(1, jp)
        w = _lut(Wt, c5 * 5 + c3, 0.0)
        contig = (it > lo) & (p5 - p5m == 1) & (p3p - p3 == 1)
        tot_p = st["tot"]
        tot = torch.where(contig, (tot_p + w) * w, w)
        tmp = torch.where(tot == 0, 0, st["tmp"] + 1)
        At = _lut(PT, c5m * 5 + c3p, 7)
        Bt = _lut(PT, c3 * 5 + c5, 7)
        g = torch.where((At <= 6) & (Bt <= 6),
                        ST[(At * 8 + Bt).clamp(0, 63).long()], 0).long()
        in_run = (tot != 0) & (tot_p != 0) & contig
        sE = torch.where((tot == 0) | (tot_p == 0), 0,
                         torch.where(in_run, st["sE"] + g, st["sE"]))
        z1c = z1[:, it:it + 1] * (p3 + 1) + z1.gather(1, jp) * (p5 + 1)
        z2c = z2[:, it:it + 1] * (p3 + 1) + z2.gather(1, jp) * (p5 + 1)
        hd1 = torch.where(tot == 0, 0, (st["hd1"] + z1c) & MASK32)
        hd2 = torch.where(tot == 0, 0, (st["hd2"] + z2c) & MASK32)
        heavy = run & (it - lo < half)
        upd = heavy & ((p3 - p5) > cfg.min_hp) & (tot >= st["ms"])
        new = dict(tot=tot, tmp=tmp, sE=sE, hd1=hd1, hd2=hd2)
        for k, v in new.items():
            st[k] = torch.where(heavy, v, st[k])
        for k, v in dict(ms=tot, nb=tmp, mi=it, mj=jp, bsE=sE, bh1=hd1,
                         bh2=hd2).items():
            st[k] = torch.where(upd, v, st[k])
        st["cor"] = torch.where(run, st["cor"] + w, st["cor"])
        c3p, p3p = c3, p3
    # lane m-1 ends on lag m-1; every lane before it ends on lag t+m
    A = {k: torch.where(t == m - 1, st[k], A[k]) for k in finals}
    idx_b = torch.where(t <= m - 2, t + m, 2 * N)
    for key, k in zip(KEYS, finals):
        o = out[key]
        o[:, :N] = torch.where(t < m, A[k], o[:, :N])
        o.scatter_(1, idx_b, st[k].to(o.dtype))
        o = o[:, : 2 * N].reshape(lead + (2 * N,))
        out[key] = o if key == "cor_raw" else (
            _to_i32(o) if key in ("hd1", "hd2") else o.to(torch.int32))
    return out


# operations per cell, counted from the recurrence (as wavefront_tables_ref
# states it, one scalar operation per arithmetic, compare or select):
# a cell inside the half-window runs the whole recurrence (60 int32, 6
# float32 operations: index 1, weight lookup 4, contiguity 7, tot 3, run
# length 3, stack energy 14, in-run 3, sE 4, hash deltas 12, update test 7,
# update 7, correlation add 1), a cell past it adds its weight to the
# correlation (5 int32, 1 float32), a lag with no region cell takes its
# closed form (6 int32)
WINDOW_CELL_OPS = (60, 6)
COR_CELL_OPS = (5, 1)
PAD_LAG_OPS = (6, 0)


def wavefront_work(mlen, N: int) -> dict:
    """Bytes and operations one call on regions of lengths `mlen` needs.

    bytes: every input the function needs read once and every output
    written once.  Under the layout contract the tail of a region past
    its m positions is known (position N, code 0), so a region needs
    its length and the m real entries of its four rows, (4 m + 1) * 4
    bytes, and writes 7 * 2N * 4; the call reads the 25 weights and the
    625 stack energies once.  Cells: a region of length m has m * m
    cells on lags 0..2m-2; a lag of len cells keeps the window state
    over its first ceil(len / 2) of them.  Counts what these regions
    need, not the N entries and N * N cells of a full one."""
    m = np.asarray(mlen.cpu() if isinstance(mlen, torch.Tensor) else mlen,
                   np.int64).reshape(-1)

    def tri(k):                      # sum of ceil(l / 2) for l = 1..k
        k = np.maximum(k, 0)
        return ((k + 1) // 2) * ((k + 2) // 2)

    window = int((tri(m) + tri(m - 1)).sum())
    cells = int((m * m).sum())
    cor_only = cells - window
    pad_lags = int((2 * N - np.maximum(2 * m - 1, 0)).sum())
    counts = ((window, WINDOW_CELL_OPS), (cor_only, COR_CELL_OPS),
              (pad_lags, PAD_LAG_OPS))
    return dict(
        regions=int(m.size), cells=cells, window_cells=window,
        cor_cells=cor_only, pad_lags=pad_lags,
        positions=int(m.sum()),
        bytes=(int((4 * m + 1).sum()) + int(m.size) * 7 * 2 * N + 25 + 625) * 4,
        int_ops=sum(n * ops[0] for n, ops in counts),
        f32_ops=sum(n * ops[1] for n, ops in counts))


def check_layout(cfg, tabs, rcodes, rpos, mlen, z1row, z2row):
    """Raise ValueError unless the wrapper's arguments keep the layout
    contract of the module note.  It reads the device (one host read),
    so it is for tests and checks and stays out of the fold step: the
    wrapper itself cannot tell, and outside the contract the kernel and
    wavefront_tables_ref give different tables."""
    N = rcodes.shape[-1]
    j = torch.arange(N, device=rcodes.device)
    real = j < mlen[..., None]
    nxt = F.pad(rpos[..., 1:], (0, 1), value=N)
    faults = {
        "min_hp < 0": torch.tensor(cfg.min_hp < 0),
        "a weight of code 0 is not 0": (tabs.W[:5] != 0) | (tabs.W[::5] != 0),
        "mlen outside 0..N": (mlen < 0) | (mlen > N),
        "a member position outside 0..N-1": real & ((rpos < 0) | (rpos >= N)),
        "member positions do not ascend strictly":
            (j + 1 < mlen[..., None]) & (nxt <= rpos),
        "a position past mlen is not N": ~real & (rpos != N),
        "a code past mlen is not 0": ~real & (rcodes != 0),
    }
    hit = torch.stack([x.any().to(rcodes.device) for x in faults.values()])
    bad = [name for name, h in zip(faults, hit.tolist()) if h]
    if bad:
        raise ValueError("wavefront layout contract broken: " + "; ".join(bad))


def empty_tables(shape, device):
    """The seven output tables of a call on rcodes of `shape` [..., R, N],
    uninitialised: the kernel writes every entry."""
    *lead, R, N = shape
    return {k: torch.empty(tuple(lead) + (R, 2 * N),
                           dtype=torch.float32 if k == "cor_raw" else torch.int32,
                           device=device) for k in KEYS}


def _check_args(cfg, tabs, rcodes, rpos, mlen, z1row, z2row, out):
    """The wrapper's checks of device, type, shape and contiguity (host
    metadata only: no device read)."""
    dev = rcodes.device
    if cfg.min_hp < 0:
        raise ValueError("wavefront_tables: min_hp must be >= 0")
    *lead, R, N = rcodes.shape
    for name, x in (("rcodes", rcodes), ("rpos", rpos), ("z1row", z1row),
                    ("z2row", z2row), ("mlen", mlen)):
        want = tuple(lead) + ((R,) if name == "mlen" else (R, N))
        if x.device != dev or x.dtype != torch.int32 or tuple(x.shape) != want:
            raise ValueError(f"wavefront_tables: {name} must be int32 {want} "
                             f"on {dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"wavefront_tables: {name} must be contiguous "
                             "and 16-byte aligned")
    for name, x, dt, n in (("W", tabs.W, torch.float32, 25),
                           ("SE", tabs.SE, torch.int32, 625)):
        if (x.device != dev or x.dtype != dt or tuple(x.shape) != (n,)
                or not x.is_contiguous()):
            raise ValueError(f"wavefront_tables: table {name} must be {dt} "
                             f"[{n}] on {dev}: build it with small_tables")
    want = tuple(lead) + (R, 2 * N)
    for k in KEYS if out is not None else ():
        dt = torch.float32 if k == "cor_raw" else torch.int32
        x = out[k]
        if (x.device != dev or x.dtype != dt or tuple(x.shape) != want
                or not x.is_contiguous()):
            raise ValueError(f"wavefront_tables: out[{k!r}] must be {dt} "
                             f"{want} on {dev}: make it with empty_tables")


def wavefront_tables(cfg, tabs, rcodes, rpos, mlen, z1row, z2row, out=None):
    """Per-lag window-scan tables (see wavefront_tables_ref).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    in csrc/wavefront.cu on the current stream (built at first use) or
    raise.  The inputs must keep the module's layout contract.  `out`,
    tables from empty_tables, receives the result (a fold step passes the
    same tables every step); else new tables are allocated.

    The checks of device, type, shape, contiguity and alignment run on
    every call but inside a CUDA graph capture, which records the launch
    only: there the wrapper raises unless a call of the same signature
    (shape, device, min_hp, whether `out` is given) was checked before
    the capture."""
    dev = rcodes.device
    if not KERNEL.on_card(dev):
        return wavefront_tables_ref(cfg, tabs, rcodes, rpos, mlen,
                                    z1row, z2row)
    KERNEL.check((tuple(rcodes.shape), dev, cfg.min_hp, out is None),
                 _check_args, cfg, tabs, rcodes, rpos, mlen, z1row, z2row,
                 out)
    *lead, R, N = rcodes.shape
    regions = (int(np.prod(lead)) if lead else 1) * R
    if out is None:
        out = empty_tables(rcodes.shape, dev)
    KERNEL.launch(dev, rcodes.data_ptr(), rpos.data_ptr(), mlen.data_ptr(),
                  z1row.data_ptr(), z2row.data_ptr(), tabs.W.data_ptr(),
                  tabs.SE.data_ptr(), *(out[k].data_ptr() for k in KEYS),
                  regions, N, cfg.min_hp)
    return out
