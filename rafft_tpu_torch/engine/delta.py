"""The fold step's stage `delta`: every candidate stem's exact incremental
energy dE, in plain PyTorch and as the CUDA kernel csrc/delta.cu.

For every lane (b, k, r, m) of the candidate tensors [B, K, R, M] (beam
row k of sequence b, region slot r, its m-th best lag) the stage returns

* delta int32: the stem's exact integer dE, 0 where the lane has no run
  or is unsupported;
* unsupported bool: the stem jumps an excised gap of its region, or the
  region's enclosing loop has more than C children (C=48): such a
  candidate is evaluated in full under the CPLX budget instead;
* has bool: the lane has a run (max_nb > 0);
* p0 int32: the stem's innermost 5' position rpos[clamp(max_i)], on
  every lane.

* _candidate_delta (with _children) is the plain version: the semantics
  of fold_jax._candidate_delta computed directly on the lanes, the CPU
  path and the kernel's yardstick;
* candidate_delta dispatches: CPU tensors take the plain version, CUDA
  tensors launch the kernel (built at first use), also inside a CUDA
  graph capture, or raise.  The kernel reads the DeviceParams tables
  themselves, no copy of them (kernel_header: the 1-D tables' lengths
  and the scalars), and its outputs are allocated per call: inside a
  capture they come from the graph's private pool, as the plain
  version's did, so the fold step holds no more memory between replays
  than before.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rafft_tpu_torch import _build
from rafft_tpu_torch.energy.eval_torch import (TABLES, _ext_stem_v,
                                               _hairpin_v, _int_loop_v,
                                               _ml_stem, _ptype, take)

# launches of the CUDA kernel, and launches recorded into CUDA graph
# captures (the plain version does not count; see _build.Kernel)
LAUNCHES = 0
CAPTURED = 0
KERNEL = _build.Kernel(
    "delta", __name__, "rafft_delta",
    [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
     ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 7 + [ctypes.c_void_p])

OUT_KEYS = ("delta", "unsupported", "has", "p0")
LOOP_KEYS = ("is_open", "enclose", "mls", "exts", "branches", "loop_e")
WS_KEYS = ("max_nb", "max_i", "max_j", "best_sE")
# the kernel keeps the first C' = min(C, N) children of a region in
# shared memory and scans them with one warp, two entries a lane
C_MAX = 64
# the largest N (fold_torch.MAX_N): the kernel stages 12 N bytes of a
# region in shared memory, and its block scan packs two counts below N
# into 16 bits each
N_MAX = 4096
# the kernel's header, in csrc/delta.cu's order: the length of each 1-D
# table, then the scalars
LENGTHS = ("hairpin", "bulge", "internal", "tetra", "tri", "hexa")
SCALARS = ("terminal_au", "ml_closing", "ml_intern", "ninio_m", "ninio_max")
HEADER = tuple(f"len.{k}" for k in LENGTHS) + SCALARS
# the tables' shapes as the kernel indexes them (the 1-D tables have any
# length, given in the header)
SHAPES = dict(pair_type=(5, 5), stack=(8, 8), mmh=(8, 5, 5), mmi=(8, 5, 5),
              mm1n=(8, 5, 5), mm23=(8, 5, 5), mmm=(8, 5, 5), mmext=(8, 5, 5),
              d5=(8, 5), d3=(8, 5), int11=(8, 8, 5, 5),
              int21=(8, 8, 5, 5, 5), int22=(8, 8, 5, 5, 5, 5))


# ======================================================================
# the plain version
# ======================================================================

def _children(cfg, pt, loops, rorder, C):
    """Per (b, k, r): the enclosing loop's direct children, ascending,
    with prefix sums of their multiloop-stem and exterior terms.

    Returns chs [B,K,R,C'] (starts, N-padded; C' = min(C, N)), pml and
    pext [B,K,R,C'+1], nch [B,K,R]."""
    N = cfg.N
    ii = torch.arange(N, dtype=torch.int32, device=pt.device)
    memb = (loops["is_open"][:, :, None, :]
            & (loops["enclose"][:, :, None, :] == rorder[..., None])
            & (rorder[..., None] > -2))
    chs = torch.where(memb, ii, N).sort(-1).values[..., :C]
    nch = memb.sum(-1, dtype=torch.int32)
    ok = chs < N
    chc = chs.clamp(0, N - 1)

    def prefix(per_child):
        x = torch.where(ok, take(per_child, chc), 0)
        return F.pad(x.cumsum(-1, dtype=torch.int32), (1, 0))

    return chs, prefix(loops["mls"]), prefix(loops["exts"]), nch


def _candidate_delta(cfg, dp, codes, n, keys, pt, loops, rorder, rpos, ws,
                     C=48):
    """Exact incremental integer dE for every candidate [B,K,R,M].

    Semantics of fold_jax._candidate_delta, computed directly on the
    [B,K,R,M] lanes.  Candidates whose stem jumps an excised gap or whose
    region has more than C children are flagged unsupported (complex)
    and resolved by full evaluation under the CPLX budget.  Returns
    (delta, unsupported, has, p0)."""
    N = cfg.N
    run, i_s, j_s, bsE = ws["max_nb"], ws["max_i"], ws["max_j"], ws["best_sE"]
    has = run > 0
    nb_ = n.view(-1, 1, 1, 1)

    # ---------- stem ends in sequence coordinates, gap detection
    jump = F.pad((rpos[..., 1:] - rpos[..., :-1] > 1).to(torch.int32), (1, 0))
    cumJ = jump.cumsum(-1, dtype=torch.int32)

    def posg(idx):
        c = idx.clamp(0, N - 1)
        return take(rpos, c), take(cumJ, c)

    p0, cj_p = posg(i_s)                     # innermost 5'
    q0, cj_q = posg(j_s)                     # innermost 3'
    a, cj_a = posg(i_s - run + 1)            # outermost 5'
    b2, cj_b = posg(j_s + run - 1)           # outermost 3'
    ngaps = torch.where(has, (cj_p - cj_a) + (cj_b - cj_q), 0)

    # ---------- children of each region's enclosing loop
    chs, pml, pext, nch = _children(cfg, pt, loops, rorder, C)
    Ceff = chs.shape[-1]
    chs_e = chs[..., None, :]

    def ssr(q):  # first child index with start > q
        return (chs_e <= q[..., None]).sum(-1, dtype=torch.int32)

    def ssl(q):  # first child index with start >= q
        return (chs_e < q[..., None]).sum(-1, dtype=torch.int32)

    def ptake(pref, idx):
        return take(pref, idx.clamp(0, Ceff))

    def prange(pref, lo, hi):
        return ptake(pref, hi) - ptake(pref, lo)

    lo_in = ssr(p0)
    hi_in = ssl(q0)
    cin = hi_in - lo_in
    fc_in = take(chs, lo_in.clamp(0, Ceff - 1))

    # ---------- codes around a position: (codes[i], codes[i-1], codes[i+1])
    codes_m1 = F.pad(codes[:, :-1], (1, 0))
    codes_p1 = F.pad(codes[:, 1:], (0, 1))

    def cg(idx):
        c = idx.clamp(0, N - 1)
        return take(codes, c), take(codes_m1, c), take(codes_p1, c)

    def m_raw(vals, idx, off):
        # bounds on the raw logical index idx+off
        j = idx + off
        return torch.where((j >= 0) & (j < nb_), vals, 0)

    def m_clip(vals, idx, off):
        # bounds on clip(idx)+off
        j = idx.clamp(0, N - 1) + off
        return torch.where((j >= 0) & (j < nb_), vals, 0)

    def clip(x):
        return x.clamp(0, N - 1)

    cv_p0, cv_q0, cv_a, cv_b2 = cg(p0), cg(q0), cg(a), cg(b2)

    # ---------- inner loop closed by (p0, q0)
    t_pq = _ptype(dp, m_clip(cv_p0[0], p0, 0), m_clip(cv_q0[0], q0, 0))
    hpE = _hairpin_v(dp, t_pq, m_clip(cv_p0[2], p0, 1),
                     m_clip(cv_q0[1], q0, -1), clip(q0) - clip(p0) - 1,
                     *(take(kk, clip(p0)) for kk in keys))
    cv_fc = cg(fc_in)
    fc_in_e = take(pt, clip(fc_in))
    cv_fe = cg(fc_in_e)
    t2_in = _ptype(dp, m_clip(cv_fe[0], fc_in_e, 0), m_clip(cv_fc[0], fc_in, 0))
    ilE = _int_loop_v(dp, t_pq, t2_in,
                      m_clip(cv_p0[2], p0, 1), m_clip(cv_q0[1], q0, -1),
                      m_clip(cv_fc[1], fc_in, -1), m_clip(cv_fe[2], fc_in_e, 1),
                      clip(fc_in) - clip(p0) - 1, clip(q0) - clip(fc_in_e) - 1)

    def mlstem_v(cv_x, x, cv_y, y):
        # stem (x, y) seen from its enclosing loop (raw-index bounds)
        t = _ptype(dp, m_raw(cv_x[0], x, 0), m_raw(cv_y[0], y, 0))
        return _ml_stem(dp, t, m_raw(cv_x[1], x, -1), m_raw(cv_y[2], y, 1))

    def mlclose_v(cv_x, x, cv_y, y):
        # closing pair (x, y) seen from inside: reversed type
        t = _ptype(dp, m_raw(cv_y[0], y, 0), m_raw(cv_x[0], x, 0))
        return _ml_stem(dp, t, m_raw(cv_y[1], y, -1), m_raw(cv_x[2], x, 1))

    mlE_in = (dp.ml_closing + mlclose_v(cv_p0, p0, cv_q0, q0)
              + prange(pml, lo_in, hi_in))
    innerE = torch.where(cin == 0, hpE, torch.where(cin == 1, ilE, mlE_in))

    # ---------- enclosing loop transition (region-level values [B,K,R,1])
    lab = rorder[..., None]
    labc = lab.clamp(0, N - 1)
    is_ext = lab == -1
    bL = take(loops["branches"], labc)
    eL = take(loops["loop_e"], labc)
    j_lab = take(pt, labc)
    cv_lab, cv_jl = cg(lab), cg(j_lab)

    lo_sw = ssr(a - 1)     # children with start >= a
    hi_sw = ssl(b2 + 1)    # children with start <= b2
    sw = hi_sw - lo_sw
    mlsub = prange(pml, lo_sw, hi_sw)
    bLn = bL - sw + 1

    t1_L = _ptype(dp, m_clip(cv_lab[0], lab, 0), m_clip(cv_jl[0], j_lab, 0))
    t2_L = _ptype(dp, m_clip(cv_b2[0], b2, 0), m_clip(cv_a[0], a, 0))
    il_new = _int_loop_v(dp, t1_L, t2_L,
                         m_clip(cv_lab[2], lab, 1), m_clip(cv_jl[1], j_lab, -1),
                         m_clip(cv_a[1], a, -1), m_clip(cv_b2[2], b2, 1),
                         clip(a) - labc - 1, clip(j_lab) - clip(b2) - 1)
    ml_total = ptake(pml, nch[..., None])
    mlE_L = (dp.ml_closing + mlclose_v(cv_lab, lab, cv_jl, j_lab)
             + ml_total - mlsub + mlstem_v(cv_a, a, cv_b2, b2))
    t_ext = _ptype(dp, m_clip(cv_a[0], a, 0), m_clip(cv_b2[0], b2, 0))
    ext_new = _ext_stem_v(dp, t_ext, m_clip(cv_a[1], a, -1),
                          m_clip(cv_b2[2], b2, 1), clip(a) > 0,
                          clip(b2) < nb_ - 1)
    ext_sub = prange(pext, lo_sw, hi_sw)
    dL = torch.where(is_ext, ext_new - ext_sub,
                     torch.where(bLn == 1, il_new - eL, mlE_L - eL))

    delta = bsE + innerE + dL
    unsupported = has & ((ngaps > 0) | (nch[..., None] > C))
    delta = torch.where(has & ~unsupported, delta, 0)
    return delta, unsupported, has, p0


# ======================================================================
# the kernel's tables
# ======================================================================

def kernel_header(dp) -> list:
    """The kernel's header for DeviceParams `dp` (HEADER: the 1-D tables'
    lengths, the scalars), after checking that every table has the shape
    the kernel indexes it by (SHAPES)."""
    for k, shape in SHAPES.items():
        if tuple(getattr(dp, k).shape) != shape:
            raise ValueError(f"candidate_delta: table {k} is "
                             f"{tuple(getattr(dp, k).shape)}, the kernel "
                             f"indexes it as {shape}")
    if dp.internal.shape[0] < 6:
        raise ValueError("candidate_delta: the internal-loop table needs 6 "
                         "entries (the 2x3 loop reads internal[5])")
    return ([getattr(dp, k).shape[0] for k in LENGTHS]
            + [getattr(dp, k) for k in SCALARS])


def delta_work(shape, N, tables_numel) -> dict:
    """Bytes one call on candidate lanes of `shape` [B, K, R, M] at
    sequence length N needs: every input read once and every output
    written once.  Reads: the four window tables and rpos [B, K, R, *];
    is_open (1 byte), enclose, mls, exts, branches, loop_e and pt
    [B, K, N]; codes, the three k-mer key rows [B, N] and n; rorder; the
    energy tables (tables_numel int32 entries).  Writes: delta and p0
    (int32), unsupported and has (bool) per lane."""
    B, K, R, M = shape
    lanes = B * K * R * M
    reads = (4 * lanes * 4 + B * K * R * N * 4 + B * K * N * (1 + 6 * 4)
             + B * N * 4 * 4 + B * 4 + B * K * R * 4 + tables_numel * 4)
    return dict(lanes=lanes, regions=B * K * R, bytes=reads + lanes * 10)


# ======================================================================
# the wrapper
# ======================================================================

def _check_args(cfg, dp, codes, n, keys, pt, loops, rorder, rpos, ws, C):
    """The wrapper's checks of device, type, shape and contiguity (host
    metadata only: no device read)."""
    dev = codes.device
    if codes.dim() != 2 or rpos.dim() != 4:
        raise ValueError("candidate_delta: codes must be [B, N] and rpos "
                         "[B, K, R, N]")
    B, N = codes.shape
    _, K, R, _ = rpos.shape
    M = ws["max_nb"].shape[-1] if ws["max_nb"].dim() == 4 else -1
    if N != cfg.N or not 1 <= N <= N_MAX:
        raise ValueError(f"candidate_delta: N={N} must equal cfg.N={cfg.N} "
                         f"and lie in 1..{N_MAX}")
    if not 1 <= C <= C_MAX:
        raise ValueError(f"candidate_delta: C={C} outside 1..{C_MAX}")
    if len(keys) != 3:
        raise ValueError("candidate_delta: keys must be the 5-, 6- and "
                         "8-mer key rows")
    kernel_header(dp)
    i32 = torch.int32
    want = [("codes", codes, i32, (B, N)), ("n", n, i32, (B,))]
    want += [(f"keys[{i}]", x, i32, (B, N)) for i, x in enumerate(keys)]
    want += [("pt", pt, i32, (B, K, N)), ("rorder", rorder, i32, (B, K, R)),
             ("rpos", rpos, i32, (B, K, R, N))]
    want += [(f"loops[{k!r}]", loops[k],
              torch.bool if k == "is_open" else i32, (B, K, N))
             for k in LOOP_KEYS]
    want += [(f"ws[{k!r}]", ws[k], i32, (B, K, R, M)) for k in WS_KEYS]
    want += [(f"table {k}", getattr(dp, k), i32,
              tuple(getattr(dp, k).shape)) for k in TABLES]
    for name, x, dt, shape in want:
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"candidate_delta: {name} must be {dt} {shape} "
                             f"on {dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"candidate_delta: {name} must be contiguous")


def candidate_delta(cfg, dp, codes, n, keys, pt, loops, rorder, rpos, ws,
                    C=48):
    """Every candidate's exact incremental dE: (delta, unsupported, has,
    p0), each [B, K, R, M] (see the module note).

    CPU tensors take the plain version (_candidate_delta); CUDA tensors
    launch the kernel in csrc/delta.cu on the current stream, into new
    outputs, or raise.

    The checks of device, type, shape and contiguity run on every call
    but inside a CUDA graph capture, which records the launch only:
    there the wrapper raises unless a call of the same signature (the
    shapes, device and C) was checked before the capture."""
    dev = codes.device
    if not KERNEL.on_card(dev):
        return _candidate_delta(cfg, dp, codes, n, keys, pt, loops, rorder,
                                rpos, ws, C)
    KERNEL.check((tuple(rpos.shape), tuple(ws["max_nb"].shape), dev, C),
                 _check_args, cfg, dp, codes, n, keys, pt, loops, rorder,
                 rpos, ws, C)
    shape = ws["max_nb"].shape
    B, K, R, M = shape
    out = [torch.empty(shape, dtype=torch.bool if k in ("unsupported", "has")
                       else torch.int32, device=dev) for k in OUT_KEYS]
    ptrs = [codes, n, *keys, pt, rorder, rpos,
            *(loops[k] for k in LOOP_KEYS), *(ws[k] for k in WS_KEYS),
            *out, *(getattr(dp, k) for k in TABLES)]
    arr = (ctypes.c_void_p * len(ptrs))(*(x.data_ptr() for x in ptrs))
    header = (ctypes.c_int * len(HEADER))(*kernel_header(dp))
    KERNEL.launch(dev, arr, len(ptrs), header, len(HEADER), B * K * R, K, R,
                  M, codes.shape[-1], C)
    return tuple(out)
