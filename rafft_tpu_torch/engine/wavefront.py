"""Anti-diagonal wavefront window scan: plain PyTorch and the CUDA kernel.

Counterpart of rafft_tpu/engine/wavefront.py.  For every region of the
region-local pair matrix (ip, jp), the reference's window-slide
recurrence depends only on the previous cell of the same anti-diagonal
lag = ip + jp, namely (ip-1, jp+1).  Sweeping rows ip = 0..mmax-1 with a
state vector over jp advances every lag at once; the raw correlation is
the running sum of pair weights along the same diagonal.

Both functions return, per lag, the same seven [..., R, 2N] tables as
the Pallas kernel, entry for entry over the whole table: lag L is
finalised at row min(L, mmax-1), where mmax is the longest region of the
beam row, and lags >= mmax+N-1 are zero.

wavefront_tables_ref is the recurrence in plain tensor ops (the CPU path
and the kernel's yardstick); wavefront_tables launches the hand-written
kernel csrc/wavefront.cu for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from rafft_tpu_torch import _build

MASK32 = 0xFFFFFFFF
KEYS = ("cor_raw", "max_nb", "max_i", "max_j", "best_sE", "hd1", "hd2")

# launches of the CUDA kernel (the plain version does not count)
LAUNCHES = 0


def _small_tables(dp, W, device):
    """Pair weights (f32), pair types and stack energies, flattened."""
    Wt = torch.as_tensor(np.asarray(W, np.float32).reshape(-1), device=device)
    PT = dp.pair_type.reshape(-1).to(device=device, dtype=torch.int32)
    ST = dp.stack.reshape(-1).to(device=device, dtype=torch.int32)
    return Wt.contiguous(), PT.contiguous(), ST.contiguous()


def _to_i32(x):
    """int64 holding a uint32 pattern -> the same bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def wavefront_tables_ref(cfg, dp, W, rcodes, rpos, mlen, z1row, z2row):
    """Per-lag window-scan tables in plain PyTorch.

    rcodes/rpos/z1row/z2row are int32 [..., R, N] (z*row: Z[rpos] as
    uint32 bit patterns), mlen int32 [..., R].  Returns dict(cor_raw f32,
    max_nb, max_i, max_j, best_sE, hd1, hd2 int32), each [..., R, 2N];
    hd1/hd2 are uint32 bit patterns."""
    N = rcodes.shape[-1]
    dev = rcodes.device
    Wt, PT, ST = _small_tables(dp, W, dev)
    i32, f32 = torch.int32, torch.float32
    mmax = mlen.amax(-1)[..., None, None]                  # [..., 1, 1]
    m = mlen[..., None]                                     # [..., R, 1]
    lane = torch.arange(N, dtype=i32, device=dev)
    z1 = z1row.long() & MASK32
    z2 = z2row.long() & MASK32

    def lut(tab, lin, default):
        ok = (lin >= 0) & (lin < tab.shape[0])
        v = tab[lin.clamp(0, tab.shape[0] - 1).long()]
        return torch.where(ok & (v != 0), v, default)

    def ptype(lin):
        return lut(PT, lin, 7)

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
        w = lut(Wt, c5 * 5 + c3, 0.0)
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


def _lib():
    lib = _build.load("wavefront")
    if not getattr(lib, "_rafft_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rafft_wavefront.argtypes = [p] * 15 + [i, i, i, i, p]
        lib.rafft_wavefront.restype = ctypes.c_int
        lib._rafft_typed = True
    return lib


def wavefront_tables(cfg, dp, W, rcodes, rpos, mlen, z1row, z2row):
    """Per-lag window-scan tables (see wavefront_tables_ref).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    in csrc/wavefront.cu on the current stream (built at first use)."""
    global LAUNCHES
    dev = rcodes.device
    if dev.type == "cpu":
        return wavefront_tables_ref(cfg, dp, W, rcodes, rpos, mlen,
                                    z1row, z2row)
    if dev.type != "cuda":
        raise ValueError(f"wavefront_tables: unsupported device {dev}")
    *lead, R, N = rcodes.shape
    for name, x in (("rcodes", rcodes), ("rpos", rpos), ("z1row", z1row),
                    ("z2row", z2row), ("mlen", mlen)):
        want = tuple(lead) + ((R,) if name == "mlen" else (R, N))
        if x.device != dev or x.dtype != torch.int32 or tuple(x.shape) != want:
            raise ValueError(f"wavefront_tables: {name} must be int32 {want} "
                             f"on {dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"wavefront_tables: {name} is not contiguous")
    Wt, PT, ST = _small_tables(dp, W, dev)
    rows = int(np.prod(lead)) if lead else 1
    out = {k: torch.empty(tuple(lead) + (R, 2 * N),
                          dtype=torch.float32 if k == "cor_raw" else torch.int32,
                          device=dev) for k in KEYS}
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().rafft_wavefront(
            rcodes.data_ptr(), rpos.data_ptr(), mlen.data_ptr(),
            z1row.data_ptr(), z2row.data_ptr(), Wt.data_ptr(), PT.data_ptr(),
            ST.data_ptr(), *(out[k].data_ptr() for k in KEYS),
            rows, R, N, cfg.min_hp, stream)
    if err != 0:
        raise RuntimeError(f"wavefront kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
