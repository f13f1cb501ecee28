"""Batched MFE (Zuker) folding in PyTorch: the anti-diagonal wavefront DP.

Counterpart of rafft_tpu/mfe/mfe_jax.py.  The O(N^3) Zuker recursion
runs as one Python loop over the anti-diagonals d, the whole batch in
each step: the interior loops of every (i, i+d) as one [B, P, L]
minimisation (P = the loop-size offsets (a, b) with a+b <= MAXLOOP+2 that
fit inside the diagonal, L = n_max - d columns), the multiloop splits as two
skewed min-plus reductions read through strided views of fML, then the
exterior prefix energies F as a loop over j.  d and j are Python ints:
nothing inside either loop reads the device, so the host enqueues the
whole fill ahead of the card.  Same integer dekacal tables as the native
C++ DP (native/turner_eval.cpp), so matrices, energies and structures are
bit-equal to it and to the JAX DP.

Matrices use diagonal indexing: Cd[b, d, i] = C(i, i+d), Md[b, d, i] =
fML(i, i+d).  Only entries that the JAX DP can make finite are computed
(d from 4, columns with i + d below the batch's longest row); the rest
stay INF, as they are there.  The traceback runs on the host from matrices copied
there once per batch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rafft_tpu_torch.energy import eval_torch as ET
from rafft_tpu_torch.energy.params import encode_sequence, get_params
from rafft_tpu_torch.struct import dot_bracket

INF = 1 << 28
MAXLOOP = 30


def _ab_pairs():
    """All interior-loop offsets (a, b): inner pair (i+a, j-b) with
    unpaired sizes (a-1) + (b-1) <= MAXLOOP."""
    ab = [(a, b) for a in range(1, MAXLOOP + 2)
          for b in range(1, MAXLOOP + 2) if (a - 1) + (b - 1) <= MAXLOOP]
    arr = np.array(ab, dtype=np.int32)
    return arr[:, 0], arr[:, 1]


_A_VEC, _B_VEC = _ab_pairs()
# the offsets by a+b: diagonal d reads the prefix with d - a - b >= 4 (an
# inner pair on a shorter diagonal is INF), in a stable order
_BY_SIZE = np.argsort(_A_VEC + _B_VEC, kind="stable")
_SIZES = (_A_VEC + _B_VEC)[_BY_SIZE]
_AB_ON: dict = {}


def _ab_on(dev):
    """The sorted offsets as int32 [2, P] on `dev`, copied there once: a
    copy from pageable host memory would wait for the device's queue."""
    if dev not in _AB_ON:
        _AB_ON[dev] = torch.as_tensor(
            np.stack([_A_VEC[_BY_SIZE], _B_VEC[_BY_SIZE]]), device=dev)
    return _AB_ON[dev]


def _skew_min(Md, d: int, shift: int, L: int | None = None):
    """min over t of fML(i+shift, i+shift+t) + fML(i+shift+t+1, i+d-shift)
    for the columns i < L (default all N), batched over Md's leading dims.

    shift=0: fML(i,u)+fML(u+1,j) for the fML recurrence; shift=1:
    fML(i+1,u)+fML(u+1,j-1) for the closing-pair decomposition.  As in
    mfe_jax._skew_min, a term is INF where its diagonal is below 4 or its
    column past N-1, and the minimum is clamped at INF.  Only the split
    points t in [4, d-2*shift-5] can give two finite terms, so only they
    are read: the first terms are a slice of rows 4.., the second a
    strided view that walks the rows d-2*shift-5.. down while the column
    walks right (stride N-1 in the flat matrix).

    The JAX function also sums an out-of-range term (INF) with an entry
    of the other segment; where that entry is negative the sum, INF - x,
    enters its minimum.  So the two agree wherever the result is a sum of
    two finite entries or INF, and differ only where the JAX result lies
    within |x| below INF.  In the fill no such value is ever kept: a
    finite fML entry on either side implies a finite fML(i+1, j) or
    fML(i, j-1), and a hairpin bounds C, both far below INF - |x|; so
    Cd and Md equal the JAX DP's entry for entry."""
    N = Md.shape[-1]
    L = N if L is None else L
    lead = Md.shape[:-2]
    T = d - 2 * shift - 8
    if T <= 0 or L <= 0:
        return Md.new_full((*lead, L), INF)
    Md = Md.contiguous()
    # t' = t - 4 counted down (u = T-1-t'), so that both views rise
    v1 = Md[..., 4:4 + T, shift:shift + L].flip(-2)
    if v1.shape[-1] < L:
        v1 = torch.nn.functional.pad(v1, (0, L - v1.shape[-1]), value=INF)
    # Md[d2, c2] with d2 = d-2*shift-5-t', c2 = i+shift+5+t' at flat
    # offset d2*N + c2 = 4N + T-1 + shift+5 + u*(N-1) + i
    base = 4 * N + T - 1 + shift + 5
    bstride = tuple(Md.stride()[:-2])
    v2 = Md.as_strided((*lead, T, L), (*bstride, N - 1, 1),
                       Md.storage_offset() + base)
    if L + shift + T + 3 >= N:
        # some c2 run past the row's end (never inside _mfe_fill)
        dev = Md.device
        t_ = T - 1 - torch.arange(T, device=dev)
        c2 = torch.arange(L, device=dev)[None, :] + (t_[:, None] + shift + 5)
        v2 = torch.where(c2 < N, v2, INF)
    return torch.clamp((v1 + v2).amin(-2), max=INF)


@torch.no_grad()
def _mfe_fill(dp, codes, n, with_f=True, n_max=None):
    """Fill Cd/Md (and F) for a batch: codes [B,N] int32, n [B] int32.

    Returns Cd, Md [B,N,N] (and F [B,N+1], E [B]), int32, equal entry
    for entry to mfe_jax._mfe_fill.  `n_max`, the longest row, is read
    from n once, before the loops, unless the caller gives it (then the
    fill never waits for the device); nothing inside the loops does.  A
    smaller n_max cuts the fill short (only for counting its work)."""
    i32 = torch.int32
    codes = codes.to(i32)
    n = n.to(i32)
    B, N = codes.shape
    dev = codes.device
    if n_max is None:
        n_max = int(n.max()) if B else 0
    ii = torch.arange(N, dtype=i32, device=dev)
    keys = [ET._kmer_keys(codes, k) for k in (5, 6, 8)]
    ab = _ab_on(dev)
    a_col, b_col = ab[0][:, None], ab[1][:, None]            # [P, 1]
    can = ET._g(dp.pair_type, codes[:, :, None], codes[:, None, :]) > 0
    Cd = torch.full((B, N, N), INF, dtype=i32, device=dev)
    Md = torch.full((B, N, N), INF, dtype=i32, device=dev)
    Cflat = Cd.view(B, N * N)

    def at(x):
        return ET._at(codes, n, x[None])

    for d in range(4, n_max):
        L = n_max - d               # j = i + d < n_max: the other columns stay INF
        i = ii[:L]
        j = i + d
        valid = j[None, :] < n[:, None]                       # [B, L]
        canij = can.diagonal(d, -2, -1)[:, :L] & valid

        # ---- C(i, i+d)
        hp = ET._hairpin(dp, codes, n, i[None], j[None], *keys)
        P = int(np.searchsorted(_SIZES, d - 4, side="right"))
        if P:
            a, b = a_col[:P], b_col[:P]
            q = i[None, :] + a                                # [P, L]
            r = j[None, :] - b
            # Cd[d-a-b, i+a]: diagonal d' >= 4 and column < N by the prefix
            flat = ((d - a - b) * N + q).view(-1).long()
            cin = Cflat[:, flat].view(B, P, L)
            il = ET._int_loop(dp, codes, n, i[None, None], j[None, None],
                              q[None], r[None])
            best_il = torch.where(cin < INF, il + cin, INF).amin(1)
        else:
            best_il = torch.full_like(hp, INF)
        mlsplit = _skew_min(Md, d, 1, L)
        s_i, s_j = codes[:, :L], at(j)
        mlstem_close = ET._ml_stem(dp, ET._ptype(dp, s_j, s_i), at(j - 1),
                                   at(i + 1))
        best_ml = torch.where(mlsplit < INF,
                              dp.ml_closing + mlstem_close + mlsplit, INF)
        cnew = torch.minimum(torch.minimum(hp, best_il), best_ml)
        cnew = torch.where(canij, cnew, INF)
        Cd[:, d, :L] = cnew

        # ---- fML(i, i+d)
        m_left = Md[:, d - 1, 1:L + 1]                        # fML(i+1, j)
        m_left = torch.where(m_left < INF, m_left + dp.ml_base, INF)
        m_right = Md[:, d - 1, :L]                            # fML(i, j-1)
        m_right = torch.where(m_right < INF, m_right + dp.ml_base, INF)
        stem = torch.where(cnew < INF, cnew + ET._ml_stem(
            dp, ET._ptype(dp, s_i, s_j), at(i - 1), at(j + 1)), INF)
        msplit = _skew_min(Md, d, 0, L)
        mnew = torch.minimum(torch.minimum(m_left, m_right),
                             torch.minimum(stem, msplit))
        Md[:, d, :L] = torch.where(valid, mnew, INF)

    if not with_f:
        return Cd, Md

    # ---- exterior F: F[k] = MFE of the prefix of length k.  Every term
    # but F[i] is known now: X[b, j, i] = C(i, j) + ext(i, j) where
    # i <= j-4, j < n and C(i, j) < INF, else INF
    jj, ic = ii[:, None], ii[None, :]
    cij = Cflat[:, ((jj - ic).clamp(0, N - 1) * N + ic).view(-1).long()]
    cij = cij.view(B, N, N)
    ext = ET._ext_stem(dp, codes, n, ic[None], jj[None])
    ok = (ic <= jj - 4)[None] & (jj[None] < n[:, None, None]) & (cij < INF)
    X = torch.where(ok, cij + ext, INF)
    del cij, ext, ok
    F = torch.zeros((B, N + 1), dtype=i32, device=dev)
    for j in range(4, n_max):
        x = X[:, j, :j - 3]
        cand = torch.where(x < INF, F[:, :j - 3] + x, INF)
        best = torch.minimum(F[:, j], cand.amin(-1))
        F[:, j + 1] = torch.where(j < n, best, F[:, j])
    if n_max < N:
        F[:, n_max + 1:] = F[:, n_max, None]
    energy = F.gather(1, n.clamp(0, N).long()[:, None])[:, 0]
    return Cd, Md, F, energy


# ======================================================================
# host-side traceback (numpy, reads the matrices copied from the device)
# ======================================================================

def _traceback(seq, Cd, Md, F, params):
    from rafft_tpu_torch.energy.eval_np import (_ext_stem as np_ext,
                                                _hairpin as np_hp,
                                                _int_loop as np_il,
                                                _ml_stem as np_mls,
                                                _ptype as np_pt)

    s = encode_sequence(seq)
    useq = seq.upper().replace("T", "U")
    n = len(seq)
    N = Cd.shape[0]
    INFV = INF

    def C(i, j):
        return int(Cd[j - i, i]) if 0 <= j - i < N else INFV

    def M(i, j):
        return int(Md[j - i, i]) if 0 <= j - i < N else INFV

    def mlstem(i, j):
        return np_mls(s, n, np_pt(s, i, j), i - 1, j + 1, params)

    pt = np.full(n, -1, dtype=np.int32)
    stk = [(0, 0, n - 1)]
    while stk:
        kind, i, j = stk.pop()
        if kind == 0:  # exterior [0..j]
            jj = j
            while jj >= 4:
                if F[jj + 1] == F[jj]:
                    jj -= 1
                    continue
                hit = False
                for i2 in range(0, jj - 3):
                    cc = C(i2, jj)
                    if cc >= INFV:
                        continue
                    if (F[i2] if i2 > 0 else 0) + cc + np_ext(
                            s, n, i2, jj, params) == F[jj + 1]:
                        pt[i2], pt[jj] = jj, i2
                        stk.append((1, i2, jj))
                        jj = i2 - 1
                        hit = True
                        break
                if not hit:
                    jj -= 1
        elif kind == 1:  # C(i,j)
            target = C(i, j)
            if target == np_hp(s, useq, i, j, params):
                continue
            hit = False
            for p in range(i + 1, min(i + MAXLOOP + 1, j - 5) + 1):
                qmin = max(p + 4, j - 1 - (MAXLOOP - (p - i - 1)))
                for q in range(j - 1, qmin - 1, -1):
                    cc = C(p, q)
                    if cc >= INFV:
                        continue
                    if np_il(s, i, j, p, q, params) + cc == target:
                        pt[p], pt[q] = q, p
                        stk.append((1, p, q))
                        hit = True
                        break
                if hit:
                    break
            if hit:
                continue
            base = (params.ml_closing
                    + np_mls(s, n, np_pt(s, j, i), j - 1, i + 1, params))
            for u in range(i + 5, j - 5):
                if M(i + 1, u) + M(u + 1, j - 1) + base == target:
                    stk.append((2, i + 1, u))
                    stk.append((2, u + 1, j - 1))
                    break
        else:  # fML segment
            ii_, jj_ = i, j
            while ii_ < jj_:
                target = M(ii_, jj_)
                if target >= INFV:
                    break
                if M(ii_ + 1, jj_) + params.ml_base == target:
                    ii_ += 1
                    continue
                if M(ii_, jj_ - 1) + params.ml_base == target:
                    jj_ -= 1
                    continue
                if C(ii_, jj_) < INFV and \
                        C(ii_, jj_) + mlstem(ii_, jj_) == target:
                    pt[ii_], pt[jj_] = jj_, ii_
                    stk.append((1, ii_, jj_))
                    break
                done = False
                for u in range(ii_ + 4, jj_ - 4):
                    if M(ii_, u) + M(u + 1, jj_) == target:
                        stk.append((2, ii_, u))
                        ii_ = u + 1
                        done = True
                        break
                if not done:
                    break
    return pt


class MfeEngine:
    """Batched MFE engine for one (N, temperature) pair on one device."""

    def __init__(self, N: int, temperature: float = 37.0, B: int = 8,
                 device="cuda"):
        self.N = N
        self.B = B
        self.temperature = temperature
        self.device = torch.device(device)
        self.dp = ET.device_params(temperature, N, self.device)
        self.params = get_params(temperature)

    def _encode(self, seqs):
        B, N = self.B, self.N
        if len(seqs) > B:
            raise ValueError(f"{len(seqs)} sequences for a batch of {B}")
        codes = np.zeros((B, N), np.int32)
        n = np.zeros(B, np.int32)
        for b, s in enumerate(seqs):
            c = encode_sequence(s)
            if len(c) > N:
                raise ValueError(f"a sequence of {len(c)} nt for N={N}")
            codes[b, : len(c)] = c
            n[b] = len(c)
        return (torch.as_tensor(codes, device=self.device),
                torch.as_tensor(n, device=self.device), int(n.max()))

    def fill(self, seqs, with_f=True):
        """The device matrices of one batch (_mfe_fill on the padded batch,
        the longest row known on the host: no read of the device)."""
        codes, n, n_max = self._encode(seqs)
        return _mfe_fill(self.dp, codes, n, with_f=with_f, n_max=n_max)

    def fold(self, seqs, structures=True, timing=None):
        """Returns list of (dot_bracket|None, energy_kcal) per sequence.

        `timing`, a dict, gets the seconds of the fill (the device
        synchronised after it) and of the copies and tracebacks added to
        its "fill" and "host" entries."""
        t0 = time.perf_counter()
        Cd, Md, F, E = self.fill(seqs)
        if timing is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            timing["fill"] = timing.get("fill", 0.0) + t1 - t0
            t0 = t1
        E = E.cpu().numpy()
        if structures:
            # one copy of each matrix per batch
            Cd, Md, F = (x.cpu().numpy() for x in (Cd, Md, F))
        out = []
        for b, seq in enumerate(seqs):
            e = float(E[b]) / 100.0
            if not structures:
                out.append((None, e))
                continue
            pt = _traceback(seq, Cd[b], Md[b], F[b], self.params)
            pairs = [(i, int(j)) for i, j in enumerate(pt) if j > i]
            out.append((dot_bracket(pairs, len(seq)), e))
        if timing is not None:
            timing["host"] = timing.get("host", 0.0) + time.perf_counter() - t0
        return out


def mfe_batch(seqs, temperature: float = 37.0, N: int | None = None,
              device="cuda"):
    """One-shot batched MFE over a list of sequences."""
    if N is None:
        N = 1 << max(5, int(np.ceil(np.log2(max(len(s) for s in seqs)))))
    eng = MfeEngine(N, temperature, B=len(seqs), device=device)
    return eng.fold(seqs)
