"""The fold step's stage `enumerate`: the windowed walk of the combination
space, in plain PyTorch and as the CUDA kernel csrc/enumerate.cu.

Per lane b, every beam row k offers prod_k combinations: one accepted
candidate (in the row's per-region order, best dE first) for each region
that has any, the last region varying fastest.  The rows' combinations
are numbered g = 0, 1, ... in row order, and the stage walks them in
windows of V slots, at most W windows a step (fold_jax :1076-1359).  A
slot's combination is new when its Zobrist key (hashes composed
additively from the row's and the candidates' hash deltas) is the first
processed one of its key in the window and is not in the lane's seen
set.  New combinations enter the seen set, in slot order, and a running
top-K of them by (E, g).  Once a lane has counted max_branch new ones it
stops after the window, keeping from there on only each later row's first
combination (its combination 0), in that window and, past it, in one more
pass (the post-cap first combos).

The stage takes the per-candidate quantities in each region's order
(Dd, Dn, Dh1, Dh2 [B, K, R, M]: dE, the live regions the stem leaves, the
two hash deltas), the accepted counts s_r [B, K, R], the rows' energies
and hashes, done, and the seen set, and returns (OUT_KEYS, bm):

* seen_h1, seen_h2 [B, S] int64: the seen set after the step, in insertion
  order; seen_cnt [B] int64, clamped to S - 1 (past it the set overflowed:
  suss);
* mode [B] int64 (M_NORM where the windows ran out: FLAG_VWINDOW), rneed
  [B] int64 (the most live regions of a new structure: over R,
  FLAG_RSLOTS), suss [B] bool (FLAG_SEEN);
* windows [B] int32: the windows the lane ran (0 for a done lane);
* bm, the running beam: valid [B, K] bool, E, tie, kv [B, K] int64, idx
  [B, K, R] int64, on [B, K, R] bool, h1, h2 [B, K] int64.  Its rows are
  the step's new combinations by (E, tie) ascending, then the rows it was
  started with (valid False, E INFE, the rest 0), which the pool's sort
  can still pick.

* _enumerate_combos is the plain version, the CPU path and the kernel's
  yardstick: the engine's loop over all W windows, in which a per-lane
  mask freezes the lanes that have finished;
* enumerate_combos dispatches: CPU tensors take the plain version, CUDA
  tensors launch the kernel (built at first use), also inside a CUDA
  graph capture, or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rafft_tpu_torch import _build

M_NORM, M_FIRST, M_DONE = 0, 1, 2
INFE = 1 << 30
# combination counts saturate here (a row's product over its regions)
CLAMP = 1 << 20
MASK32 = 0xFFFFFFFF

# launches of the CUDA kernel, and launches recorded into CUDA graph
# captures (the plain version does not count; see _build.Kernel)
LAUNCHES = 0
CAPTURED = 0
KERNEL = _build.Kernel(
    "enumerate", __name__, "rafft_enumerate",
    [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int] + [ctypes.c_int] * 7
    + [ctypes.c_longlong, ctypes.c_void_p])

OUT_KEYS = ("seen_h1", "seen_h2", "seen_cnt", "mode", "rneed", "suss",
            "windows")
BM_KEYS = ("valid", "E", "tie", "kv", "idx", "on", "h1", "h2")
# what the kernel takes: V slots a window in shared memory (its sorts
# index them in 16 bits), K <= 255 rows (a slot's row in 8 bits), R <= 64
# (a slot's live regions in 8 bits), M < 2^16 (a region's accepted count
# in 16 bits), S < 2^16 (the seen set's splitters in shared memory)
V_MAX = 4096
K_MAX = 255
R_MAX = 64
M_MAX = 65535
S_MAX = 65535


# ======================================================================
# helpers (fold_torch imports them)
# ======================================================================

def _rows(tab, idx):
    """tab[b, idx[b, ...]] for tab [B, K, ...] and idx [B, ...]."""
    b = torch.arange(tab.shape[0], device=tab.device)
    return tab[b.view(-1, *([1] * (idx.dim() - 1))), idx.long()]


def _hkey(h1, h2):
    """Bijective int64 key of a (uint32, uint32) hash pair."""
    return (h1 - (1 << 31)) * (1 << 32) + h2


def _lexsort2(primary, secondary):
    """Stable argsort by (primary, secondary); secondary in [0, 2^32)."""
    return torch.sort(primary.long() * (1 << 32) + secondary, dim=-1,
                      stable=True).indices


def _first_occurrence(proc, key):
    """proc[v] and v is the first processed slot holding its key (the
    jnp.lexsort((v, ~proc, h1, h2)) dedup of fold_jax)."""
    o1 = torch.sort((~proc).to(torch.uint8), dim=-1, stable=True).indices
    o2 = torch.sort(key.gather(-1, o1), dim=-1, stable=True).indices
    ordh = o1.gather(-1, o2)
    ks = key.gather(-1, ordh)
    first = torch.ones_like(proc)
    first[..., 1:] = ks[..., 1:] != ks[..., :-1]
    return torch.zeros_like(proc).scatter(-1, ordh, first) & proc


def _member(keys, cnt, q):
    """q[b, v] is among keys[b, :cnt[b]] (sorted-set membership; the
    same answer as the all-pairs comparison of fold_jax, in O(S log S))."""
    S = keys.shape[-1]
    big = torch.iinfo(torch.int64).max
    valid = torch.arange(S, device=keys.device) < cnt[:, None]
    sk = torch.where(valid, keys, big).sort(-1).values
    pos = torch.searchsorted(sk, q)
    hit = sk.gather(-1, pos.clamp(max=S - 1)) == q
    big_hit = (valid & (keys == big)).any(-1, keepdim=True)
    return torch.where(q == big, big_hit, hit)


# ======================================================================
# the plain version
# ======================================================================

def _enumerate_combos(cfg, Dd, Dn, Dh1, Dh2, s_r, energy, ph1, ph2, done,
                      seen_h1, seen_h2, seen_cnt):
    """The windowed combination enumeration of one step for every lane
    (see the module note): returns (dict of OUT_KEYS, bm)."""
    K, R, M, V, S = cfg.K, cfg.R, cfg.M, cfg.V, cfg.S
    B = Dd.shape[0]
    dev = Dd.device
    i32 = torch.int32
    part = s_r > 0
    sz = torch.where(part, s_r, 1).long()
    prod_k = torch.ones((B, K), dtype=torch.int64, device=dev)
    for r in range(R):
        prod_k = (prod_k * sz[:, :, r]).clamp(max=CLAMP)
    prod_k = torch.where(part.any(-1), prod_k, 0)
    participating = prod_k > 0
    Pk = prod_k.cumsum(-1)
    first_start = Pk - prod_k
    total = Pk[:, -1]

    kk = torch.arange(K, device=dev)
    vv = torch.arange(V, device=dev)
    rr = torch.arange(R, device=dev)
    z64 = lambda *s: torch.zeros(s, dtype=torch.int64, device=dev)
    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
    mode, base, nbr = z64(B), z64(B), z64(B)
    kcap = torch.full((B,), K, dtype=torch.int64, device=dev)
    # one scratch column at S takes the writes of non-new slots
    s_h1 = F.pad(seen_h1, (0, 1))
    s_h2 = F.pad(seen_h2, (0, 1))
    s_cnt = seen_cnt.long()
    bm = dict(valid=zb(B, K), E=torch.full((B, K), INFE, dtype=torch.int64,
                                           device=dev),
              tie=z64(B, K), kv=z64(B, K), idx=z64(B, K, R),
              on=zb(B, K, R), h1=z64(B, K), h2=z64(B, K))
    # the most live regions of any new structure (more than R slots
    # drop regions: flag r_slots), and seen-set overflow
    rneed, suss = z64(B), zb(B)
    windows = torch.zeros(B, dtype=i32, device=dev)

    def merge(bm, E, tie, extra):
        """Merge candidate rows into the running top-K beam."""
        E2 = torch.cat([bm["E"], E], 1)
        tie2 = torch.cat([bm["tie"], tie], 1)
        o = _lexsort2(E2, tie2)[:, :K]
        out = dict(E=E2.gather(1, o), tie=tie2.gather(1, o))
        for k, x in extra.items():
            out[k] = _rows(torch.cat([bm[k], x], 1), o)
        return out

    # every window runs, as the JAX while_loop's bound allows: a lane
    # that has finished (or never ran) is frozen by `run`, so a window
    # with no lane left to run is a no-op on the state
    for _ in range(cfg.W):
        run = (mode == M_NORM) & ~done
        windows = windows + run.to(i32)
        g = base[:, None] + vv                                  # [B,V]
        kv = torch.searchsorted(Pk, g, right=True)
        kvc = kv.clamp(0, K - 1)
        local = g - torch.where(kv > 0, Pk.gather(1, (kv - 1).clamp(0, K - 1)),
                                0)
        v_ok = (g < total[:, None]) & ~done[:, None]

        szk = _rows(sz, kvc)                                    # [B,V,R]
        # stride_r = product of the sizes after r (last region varies
        # fastest); the clamp is lossless since local < prod <= CLAMP
        stride = torch.ones_like(szk)
        acc = torch.ones_like(g)
        for r in range(R - 1, -1, -1):
            stride[..., r] = acc
            acc = (acc * szk[..., r]).clamp(max=CLAMP)
        idx_r = (local[..., None] // stride) % szk
        on_r = _rows(part, kvc)

        lin = ((kvc[..., None] * R + rr) * M + idx_r).reshape(B, -1)
        pick = lambda D: D.reshape(B, -1).gather(1, lin).view(B, V, R)
        d_delta, d_nlive, d_h1, d_h2 = pick(Dd), pick(Dn), pick(Dh1), pick(Dh2)

        new_E = energy.gather(1, kvc) + torch.where(on_r, d_delta, 0).sum(-1)
        nlive = torch.where(on_r, d_nlive, 0).sum(-1)
        # combination hashes compose additively (mod 2^32)
        h1 = (ph1.gather(1, kvc) + torch.where(on_r, d_h1, 0).sum(-1)) & MASK32
        h2 = (ph2.gather(1, kvc) + torch.where(on_r, d_h2, 0).sum(-1)) & MASK32
        key = _hkey(h1, h2)
        in_seen = _member(_hkey(s_h1[:, :S], s_h2[:, :S]), s_cnt, key)

        # pass 1: locate the max_branch cap within this window
        new1 = v_ok & _first_occurrence(v_ok, key) & ~in_seen
        nb1 = nbr[:, None] + new1.long().cumsum(-1)
        capped_now = nb1[:, -1] >= cfg.max_branch
        at_cap = new1 & (nb1 == cfg.max_branch)
        cap_v = torch.where(capped_now, at_cap.to(i32).argmax(-1), V)
        kcap_w = torch.where(
            capped_now, kv.gather(1, cap_v.clamp(0, V - 1)[:, None])[:, 0],
            kcap)

        # pass 2: the processed set (prefix + post-cap first combos)
        processed = v_ok & torch.where(
            capped_now[:, None],
            (vv <= cap_v[:, None]) | ((kv > kcap_w[:, None]) & (local == 0)),
            True)
        newmask = _first_occurrence(processed, key) & ~in_seen
        rank = newmask.long().cumsum(-1) - 1
        n_new = newmask.sum(-1)
        rneed_w = torch.maximum(
            rneed, torch.where(newmask, nlive, 0).amax(-1))

        # insert into seen: only new slots are written
        slot = s_cnt[:, None] + rank
        slot = torch.where(newmask & (slot < S), slot, S)
        s_h1_w = s_h1.scatter(1, slot, h1)
        s_h2_w = s_h2.scatter(1, slot, h2)
        s_cnt_new = s_cnt + n_new
        suss_w = suss | (s_cnt_new > S - 1)

        # window top-K of new structures -> running beam
        wE = torch.where(newmask, new_E, INFE)
        ord_w = torch.sort(wE, dim=-1, stable=True).indices[:, :K]
        bm_w = merge(bm, wE.gather(1, ord_w), g.gather(1, ord_w), dict(
            valid=newmask.gather(1, ord_w), kv=kvc.gather(1, ord_w),
            idx=_rows(idx_r, ord_w), on=_rows(on_r, ord_w),
            h1=h1.gather(1, ord_w), h2=h2.gather(1, ord_w)))

        exhausted = base + V >= total
        need_first = capped_now & (
            participating & (kk > kcap_w[:, None])
            & (first_start >= (base + V)[:, None])).any(-1)
        mode_w = torch.where(
            capped_now, torch.where(need_first, M_FIRST, M_DONE),
            torch.where(exhausted, M_DONE, M_NORM))

        # commit the lanes that ran this window
        r1, r2, r3 = run[:, None], run[:, None, None], run
        s_h1 = torch.where(r1, s_h1_w, s_h1)
        s_h2 = torch.where(r1, s_h2_w, s_h2)
        s_cnt = torch.where(r3, s_cnt_new.clamp(max=S - 1), s_cnt)
        nbr = torch.where(r3, nbr + n_new, nbr)
        kcap = torch.where(r3, kcap_w, kcap)
        rneed = torch.where(r3, rneed_w, rneed)
        suss = torch.where(r3, suss_w, suss)
        bm = {k: torch.where(r2 if v.dim() == 3 else r1, bm_w[k], v)
              for k, v in bm.items()}
        base = torch.where(r3 & (mode_w == M_NORM), base + V, base)
        mode = torch.where(r3, mode_w, mode)

    # ---- post-cap first combos beyond the last window, at [K] width
    f_ok = (((mode == M_FIRST) & ~done)[:, None] & participating
            & (kk > kcap[:, None]) & (first_start >= (base + V)[:, None]))
    fE = energy + torch.where(part, Dd[..., 0], 0).sum(-1)
    fh1 = (ph1 + torch.where(part, Dh1[..., 0], 0).sum(-1)) & MASK32
    fh2 = (ph2 + torch.where(part, Dh2[..., 0], 0).sum(-1)) & MASK32
    f_nlive = torch.where(part, Dn[..., 0], 0).sum(-1)
    fkey = _hkey(fh1, fh2)
    f_inseen = _member(_hkey(s_h1[:, :S], s_h2[:, :S]), s_cnt, fkey)
    f_new = _first_occurrence(f_ok, fkey) & ~f_inseen
    fslot = s_cnt[:, None] + f_new.long().cumsum(-1) - 1
    fslot = torch.where(f_new & (fslot < S), fslot, S)
    s_h1 = s_h1.scatter(1, fslot, fh1)
    s_h2 = s_h2.scatter(1, fslot, fh2)
    f_cnt = s_cnt + f_new.sum(-1)
    suss = suss | (f_cnt > S - 1)
    s_cnt = f_cnt.clamp(max=S - 1)
    rneed = torch.maximum(rneed, torch.where(f_new, f_nlive, 0).amax(-1))
    bm = merge(bm, torch.where(f_new, fE, INFE), first_start, dict(
        valid=f_new, kv=kk.expand(B, K), idx=z64(B, K, R),
        on=part, h1=fh1, h2=fh2))
    out = dict(seen_h1=s_h1[:, :S], seen_h2=s_h2[:, :S], seen_cnt=s_cnt,
               mode=mode, rneed=rneed, suss=suss, windows=windows)
    return out, bm


def enumerate_work(s_r, windows, V, S) -> dict:
    """Bytes one call moves if each byte it must touch moves once, for
    lanes with accepted counts s_r [B, K, R] that ran `windows` [B] windows
    of V slots, with a seen set of S slots:

    * the candidate entries the decoded slots reach (Dd, Dn int32 and Dh1,
      Dh2 int64: 24 bytes each), per lane at most its accepted entries and
      at most R a slot (a lane that ran no window reads none), and s_r;
    * the seen set (two int64 halves, B x S each) read for its sort key and
      again for its copy, the key written, sorted (read and written once)
      and the copy written: nine B x S int64 passes.

    The kernel is latency-bound (csrc/enumerate.cu); this is the floor
    that bytes alone would set."""
    B, K, R = s_r.shape
    reach = torch.minimum(s_r.long().sum((1, 2)), windows.long() * V * R)
    entries = int(reach.sum())
    return dict(entries=entries,
                bytes=entries * (4 + 4 + 8 + 8) + B * K * R * 4
                + 9 * B * S * 8)


# ======================================================================
# the wrapper
# ======================================================================

def _check_args(cfg, Dd, Dn, Dh1, Dh2, s_r, energy, ph1, ph2, done, seen_h1,
                seen_h2, seen_cnt):
    """The wrapper's checks of the configuration and of device, type,
    shape and contiguity (host metadata only: no device read)."""
    K, R, M, V, S = cfg.K, cfg.R, cfg.M, cfg.V, cfg.S
    for name, value, hi in (("V", V, V_MAX), ("K", K, K_MAX), ("R", R, R_MAX),
                            ("M", M, M_MAX), ("S", S, S_MAX)):
        if not 1 <= value <= hi:
            raise ValueError(f"enumerate_combos: {name}={value} outside "
                             f"1..{hi}, what the kernel takes")
    if not K <= V or cfg.W < 1:
        raise ValueError(f"enumerate_combos: V={V} must be >= K={K} and "
                         f"W={cfg.W} >= 1")
    dev = Dd.device
    B = Dd.shape[0]
    i32, i64 = torch.int32, torch.int64
    want = [("Dd", Dd, i32, (B, K, R, M)), ("Dn", Dn, i32, (B, K, R, M)),
            ("Dh1", Dh1, i64, (B, K, R, M)), ("Dh2", Dh2, i64, (B, K, R, M)),
            ("s_r", s_r, i32, (B, K, R)), ("energy", energy, i32, (B, K)),
            ("ph1", ph1, i64, (B, K)), ("ph2", ph2, i64, (B, K)),
            ("done", done, torch.bool, (B,)),
            ("seen_h1", seen_h1, i64, (B, S)),
            ("seen_h2", seen_h2, i64, (B, S)),
            ("seen_cnt", seen_cnt, i32, (B,))]
    for name, x, dt, shape in want:
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"enumerate_combos: {name} must be {dt} {shape} "
                             f"on {dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"enumerate_combos: {name} must be contiguous")


def enumerate_combos(cfg, Dd, Dn, Dh1, Dh2, s_r, energy, ph1, ph2, done,
                     seen_h1, seen_h2, seen_cnt):
    """The windowed combination enumeration of one step: (dict of
    OUT_KEYS, bm), see the module note.

    CPU tensors take the plain version (_enumerate_combos); CUDA tensors
    launch the kernel in csrc/enumerate.cu on the current stream, into
    new outputs, or raise.  Before the launch the seen set's keys are
    sorted once (the kernel's scratch: each lane's first seen_cnt keys,
    ascending, then the largest key); the kernel's own scratch holds the
    step's inserts.  seen_cnt must be at most S - 1, as every step leaves
    it.

    The checks run on every call but inside a CUDA graph capture, which
    records the launch only: there the wrapper raises unless a call of
    the same signature (the shapes, device and configuration) was checked
    before the capture."""
    args = (cfg, Dd, Dn, Dh1, Dh2, s_r, energy, ph1, ph2, done, seen_h1,
            seen_h2, seen_cnt)
    dev = Dd.device
    if not KERNEL.on_card(dev):
        return _enumerate_combos(*args)
    KERNEL.check((tuple(Dd.shape), dev, cfg), _check_args, *args)
    B = Dd.shape[0]
    K, R, S = cfg.K, cfg.R, cfg.S
    big = torch.iinfo(torch.int64).max
    valid = torch.arange(S, device=dev) < seen_cnt[:, None]
    ordered = torch.where(valid, _hkey(seen_h1, seen_h2), big).sort(-1).values
    inserts = torch.empty((B, 2, S), dtype=torch.int64, device=dev)
    e64 = lambda *s: torch.empty(s, dtype=torch.int64, device=dev)
    eb = lambda *s: torch.empty(s, dtype=torch.bool, device=dev)
    out = dict(seen_h1=e64(B, S), seen_h2=e64(B, S), seen_cnt=e64(B),
               mode=e64(B), rneed=e64(B), suss=eb(B),
               windows=torch.empty(B, dtype=torch.int32, device=dev))
    bm = dict(valid=eb(B, K), E=e64(B, K), tie=e64(B, K), kv=e64(B, K),
              idx=e64(B, K, R), on=eb(B, K, R), h1=e64(B, K), h2=e64(B, K))
    ptrs = [Dd, Dn, Dh1, Dh2, s_r, energy, ph1, ph2, done, seen_h1, seen_h2,
            seen_cnt, ordered, inserts, *(out[k] for k in OUT_KEYS),
            *(bm[k] for k in BM_KEYS)]
    arr = (ctypes.c_void_p * len(ptrs))(*(x.data_ptr() for x in ptrs))
    KERNEL.launch(dev, arr, len(ptrs), B, K, R, cfg.M, cfg.V, cfg.W, S,
                  cfg.max_branch)
    return out, bm
