"""Batched fold engine in PyTorch (counterpart of rafft_tpu/engine/fold_jax.py).

Beam state is pair tables + energies per sequence lane; one `step`
advances every lane of the batch [B, ...] by one helix-formation step of
the reference's beam BFS, with exact incremental integer dE, the
reference's f32 acceptance, a windowed walk of the combination space
with a Zobrist-hashed seen-set, and the pool/truncate/fixed-point rule.
The design and its parity notes are fold_jax's; this module keeps its
stage and function names so each stage can be found there.

What differs from the JAX engine:

* the batch dimension B is written out (no vmap), and every tensor lives
  on the engine's explicit `device`;
* the window slide always comes from the wavefront tables
  (engine/wavefront.py: the CUDA kernel on the card, its plain version
  on the CPU), at every N up to 4096.  For integral pair weights the
  tables' correlation sums are exact and rank the lags as well; for
  non-integral weights the lags are ranked by the FFT correlation
  (_correlate, as in the JAX engine, whose float32 sums differ from the
  tables' diagonal-order sums) and the window-slide values are gathered
  from the tables at the chosen lags: they are a sequential float32
  recurrence per lag, the same in the tables and in
  fold_jax._window_scan;
* lookups are plain gathers: no one-hot einsums, no lane compaction and
  no f32 packing of dE / hash halves (dE, live-region counts and hashes
  stay integer tensors; hashes are uint32 values held in int64);
* the enumeration's while loop is a Python loop over at most W windows
  in which all lanes advance together and a per-lane mask freezes the
  lanes that have finished; one host scalar per window decides the exit.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from rafft_tpu_torch.energy.params import encode_sequence
from rafft_tpu_torch.scan.correlate import correlate_fft
from rafft_tpu_torch.scan.encode import weight_matrix
from rafft_tpu_torch.struct import Structure, dot_bracket
from rafft_tpu_torch.energy.eval_torch import (_ext_stem_v, _hairpin_v,
                                               _int_loop_v, _kmer_keys,
                                               _ml_stem, _ptype, analyze_pt,
                                               device_params, eval_pt, take)
from rafft_tpu_torch.engine.wavefront import small_tables, wavefront_tables

_LOG = logging.getLogger(__name__)
NEG = float(np.float32(-3.0e38))
MASK32 = 0xFFFFFFFF

# exactness-flag bits (out_flag / enum_suspect), equal to fold_jax's
FLAG_VWINDOW = 1    # combination V-window truncated reference combos
FLAG_RSLOTS = 2     # live regions exceeded the R slots
FLAG_SEEN = 4       # seen-set capacity S overflowed (dedup voided)
FLAG_HASH = 8       # hash-composition check failed (JAX debug builds only)
FLAG_CPLX = 16      # complex-candidate full-eval budget overflowed
FLAG_STEPLIM = 32   # fold hit the step safety limit unfinished
# flag bits -> cause names, as the sweeps' flag histograms count them
FLAG_NAMES = {FLAG_VWINDOW: "v_window", FLAG_RSLOTS: "r_slots",
              FLAG_SEEN: "seen_set", FLAG_HASH: "hash_check",
              FLAG_CPLX: "cplx_budget", FLAG_STEPLIM: "step_limit"}

M_NORM, M_FIRST, M_DONE = 0, 1, 2
INFE = 1 << 30
TBIG = 1 << 28
CLAMP = 1 << 20
# the longest padded length the engine folds (the largest bucket of the
# sweep).  What grows with N was audited up to it: the (depth, position)
# sort keys of eval_torch._enclose and the hash sums are int64, the
# Zobrist tables have N + 1 entries, flat gather indices are int64,
# CLAMP / TBIG bound combination counts, which do not depend on N, and
# the loop-size tables of energy/params.py reach 8,192 unpaired positions
MAX_N = 4096


@dataclass(frozen=True)
class EngineConfig:
    N: int = 128          # padded sequence length (bucket)
    K: int = 5            # beam width (max_stack)
    R: int = 8            # max regions per structure
    M: int = 100          # lags searched per region (nb_mode)
    V: int = 256          # combination slots per enumeration window
    W: int = 8            # max enumeration windows per step
    CPLX: int = 512       # complex-candidate full-eval budget per sequence/step
    S: int = 2048         # seen-set capacity per sequence
    max_steps: int = 24
    max_branch: int = 1000
    min_hp: int = 3
    min_nrj: float = 0.0
    temp: float = 37.0
    gc_wei: float = 3.0
    au_wei: float = 2.0
    gu_wei: float = 1.0


def _weights_integral(cfg):
    return all(float(w) == int(w) for w in (cfg.gc_wei, cfg.au_wei, cfg.gu_wei))


# ======================================================================
# helpers
# ======================================================================

def _rows(tab, idx):
    """tab[b, idx[b, ...]] for tab [B, K, ...] and idx [B, ...]."""
    b = torch.arange(tab.shape[0], device=tab.device)
    return tab[b.view(-1, *([1] * (idx.dim() - 1))), idx.long()]


def _bit(mask, flag):
    return mask.to(torch.int32) * flag


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
# per-step stages
# ======================================================================

def _regions(cfg, pt, enclose, rorder, n):
    """Compact each ordered region's member positions.

    Returns rpos [B,K,R,N] (members ascending, N-padded), rloc [B,K,N]
    (local index of each position in its region, -1 if none), rslot
    [B,K,N] (its region slot, -1 if none), mlen [B,K,R]."""
    N, R = cfg.N, cfg.R
    i32 = torch.int32
    ii = torch.arange(N, dtype=i32, device=pt.device)
    unpaired = (pt < 0) & (ii < n[:, None, None])
    memb = (unpaired[:, :, None, :]
            & (enclose[:, :, None, :] == rorder[..., None])
            & (rorder[..., None] > -2))                       # [B,K,R,N]
    rpos = torch.where(memb, ii, N).sort(-1).values
    mlen = memb.sum(-1, dtype=i32)
    loc_in_reg = memb.cumsum(-1, dtype=i32) - 1
    rslot = memb.to(i32).argmax(2)                            # first slot
    has = memb.any(2)
    rloc = torch.where(has, loc_in_reg.gather(2, rslot[:, :, None, :])[:, :, 0],
                       -1)
    rslot = torch.where(has, rslot.to(i32), -1)
    return rpos, rloc, rslot, mlen


def _lag_norm(cfg, mlen, raw):
    """Raw correlation sums [B,K,R,2N-1] over the triangle overlap count,
    NEG outside the 2m-1 lags of a region of m positions."""
    lagv = torch.arange(2 * cfg.N - 1, dtype=torch.int32, device=raw.device)
    m = mlen[..., None]
    norm = torch.minimum(lagv, (2 * m - 2 - lagv).clamp(min=0)) + 1.0
    return torch.where(lagv < 2 * m - 1, raw / norm, NEG)


def _correlate(cfg, W, rcodes, mlen, integral):
    """Normalised FFT correlation per region: [B,K,R,2N-1] float32
    (fold_jax._correlate)."""
    raw = correlate_fft(W, rcodes)
    if integral:
        raw = raw.round()
    return _lag_norm(cfg, mlen, raw)


def _top_lags(cfg, cor):
    """Descending value, ties by descending lag (reference order); a
    stable sort of the reversed correlation."""
    srt = torch.sort(cor.flip(-1), dim=-1, descending=True, stable=True)
    idx = srt.indices[..., : cfg.M]
    return ((cor.shape[-1] - 1) - idx).to(torch.int32), srt.values[..., : cfg.M]


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


def _combo_pt(cfg, pt, rloc, rslot, rpos, krow, chosen_i, chosen_j,
              chosen_run, chosen_on):
    """Position-wise construction of combination pair tables, batched.

    pt/rloc/rslot [B,K,N] and rpos [B,K,R,N] are the beam's; krow [B,X]
    names the parent beam row of each of X combinations and chosen_*
    [B,X,R] are its candidate picks.  Every position derives its new
    partner from its region's chosen stem.  Partners are gathered from
    the beam's rpos directly, never from a [B,X,R,N] copy of it."""
    N, R = cfg.N, cfg.R
    B, X = krow.shape
    rslot_x = _rows(rslot, krow)
    rc = rslot_x.clamp(0, R - 1)
    l = _rows(rloc, krow)
    ci = take(chosen_i, rc)
    cj = take(chosen_j, rc)
    crun = take(chosen_run, rc)
    con = take(chosen_on, rc) & (rslot_x >= 0)
    in5 = con & (l > ci - crun) & (l <= ci)
    in3 = con & (l >= cj) & (l < cj + crun)
    rflat = rpos.reshape(B, -1)
    row0 = (krow.long() * R)[..., None]

    def partner(local):
        lin = (row0 + rc) * N + local.clamp(0, N - 1)
        return rflat.gather(1, lin.view(B, -1)).view(B, X, N)

    # only lanes that the where() below discards can point outside their
    # region; clamping the local index keeps their gathers in bounds
    part5 = partner(cj + (ci - l))
    part3 = partner(ci - (l - cj))
    return torch.where(in5, part5, torch.where(in3, part3, _rows(pt, krow)))


# ======================================================================
# the engine
# ======================================================================

def engine_refusal(cfg: EngineConfig) -> str | None:
    """Why FoldEngine refuses `cfg`, or None where it takes it."""
    if cfg.V < cfg.K:
        return (f"V={cfg.V} must be >= K={cfg.K} (the window top-K merge "
                "gathers K slots)")
    if cfg.M > 2 * cfg.N - 1:
        return (f"M={cfg.M} exceeds the {2 * cfg.N - 1} correlation lags of "
                f"an N={cfg.N} region; clamp M to min(nb_mode, 2N-1)")
    if cfg.K > 255:
        # combo indices reach K * 2^20 and must stay below TBIG = 2^28
        return f"K={cfg.K} > 255 breaks the pool tie order"
    if cfg.min_hp < 0:
        return (f"min_hp={cfg.min_hp} must be >= 0 (the wavefront tables' "
                "padding entries assume it)")
    if cfg.N > MAX_N:
        return (f"N={cfg.N} exceeds {MAX_N}, the largest bucket the engine "
                "was audited for")
    return None


class FoldEngine:
    """Batched fold engine for one (config, batch size, device)."""

    def __init__(self, cfg: EngineConfig, B: int, device="cuda"):
        refusal = engine_refusal(cfg)
        if refusal is not None:
            raise ValueError(refusal)
        self.cfg = cfg
        self.B = B
        self.device = torch.device(device)
        self.dp = device_params(cfg.temp, cfg.N, self.device)
        self.W = weight_matrix(cfg.gc_wei, cfg.au_wei, cfg.gu_wei)
        self.integral = _weights_integral(cfg)
        # the kernel's lookup tables, uploaded once (not per step)
        self.wtabs = small_tables(self.dp, self.W, self.device)
        # Zobrist coefficients: the same draws as fold_jax, so hashes and
        # seen-sets equal the JAX engine's
        rng = np.random.default_rng(0xA5F7)
        z1 = rng.integers(1, 2**32 - 1, cfg.N + 1, dtype=np.uint64).astype(np.uint32)
        z2 = rng.integers(1, 2**32 - 1, cfg.N + 1, dtype=np.uint64).astype(np.uint32)
        dev = self.device
        self.Z1 = torch.as_tensor(z1.astype(np.int64), device=dev)
        self.Z2 = torch.as_tensor(z2.astype(np.int64), device=dev)
        self.Z1i = torch.as_tensor(z1.view(np.int32), device=dev)
        self.Z2i = torch.as_tensor(z2.view(np.int32), device=dev)

    # ---------------- state
    def _t(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _encode(self, seqs, B):
        cfg = self.cfg
        codes = np.zeros((B, cfg.N), np.int32)
        n = np.zeros(B, np.int32)
        for b, s in enumerate(seqs):
            if s is None:
                continue
            c = encode_sequence(s)
            assert len(c) <= cfg.N, (len(c), cfg.N)
            codes[b, : len(c)] = c
            n[b] = len(c)
        return codes, n

    def init_state(self, seqs: list[str], seqids=None):
        cfg, B = self.cfg, self.B
        assert len(seqs) <= B
        codes, n = self._encode(seqs, B)
        K, R, N, S = cfg.K, cfg.R, cfg.N, cfg.S
        active = np.zeros((B, K), bool)
        active[:, 0] = n > 0
        rorder = np.full((B, K, R), -2, np.int32)
        rorder[:, 0, 0] = -1          # exterior region of the unfolded root
        sid = np.full(B, -1, np.int32)
        if seqids is not None:
            sid[: len(seqids)] = seqids
        i32, i64 = torch.int32, torch.int64
        z = lambda *s, d=i32: torch.zeros(s, dtype=d, device=self.device)
        f = lambda v, *s: torch.full(s, v, dtype=i32, device=self.device)
        return dict(
            codes=self._t(codes), n=self._t(n),
            pt=f(-1, B, K, N), energy=z(B, K),
            active=self._t(active), rorder=self._t(rorder),
            seen_h1=z(B, S, d=i64), seen_h2=z(B, S, d=i64), seen_cnt=z(B),
            done=self._t(n == 0), cplx_dropped=z(B), enum_suspect=z(B),
            # continuous batching: per-lane shadow sequence, output buffer
            # for one finished fold, and bookkeeping
            seqid=self._t(sid), lane_steps=z(B),
            next_codes=z(B, N), next_n=z(B), next_seqid=f(-1, B),
            next_avail=z(B, d=torch.bool),
            out_pt=f(-1, B, K, N), out_E=z(B, K),
            out_act=z(B, K, d=torch.bool), out_n=z(B), out_seqid=f(-1, B),
            out_done=z(B, d=torch.bool), out_flag=z(B),
            out_valid=z(B, d=torch.bool),
        )

    def _refill(self, state, mask, codes_new, n_new):
        """Reset masked lanes to the unfolded root of new sequences."""
        cfg = self.cfg
        K, R = cfg.K, cfg.R
        dev = self.device
        m1 = mask[:, None]
        m2 = mask[:, None, None]
        kk = torch.arange(K, device=dev)
        root_active = (kk == 0) & (n_new[:, None] > 0)
        root_rorder = torch.full((K, R), -2, dtype=torch.int32, device=dev)
        root_rorder[0, 0] = -1
        st = dict(state)
        st["codes"] = torch.where(m1, codes_new, state["codes"])
        st["n"] = torch.where(mask, n_new, state["n"])
        st["pt"] = torch.where(m2, -1, state["pt"])
        st["energy"] = torch.where(m1, 0, state["energy"])
        st["active"] = torch.where(m1, root_active, state["active"])
        st["rorder"] = torch.where(m2, root_rorder, state["rorder"])
        st["seen_h1"] = torch.where(m1, 0, state["seen_h1"])
        st["seen_h2"] = torch.where(m1, 0, state["seen_h2"])
        st["seen_cnt"] = torch.where(mask, 0, state["seen_cnt"])
        st["done"] = torch.where(mask, n_new == 0, state["done"])
        st["cplx_dropped"] = torch.where(mask, 0, state["cplx_dropped"])
        st["enum_suspect"] = torch.where(mask, 0, state["enum_suspect"])
        return st

    def refill(self, state, slots, seqs):
        """Host API: place `seqs` into batch slots `slots` (lists)."""
        B = self.B
        mask = np.zeros(B, bool)
        mask[list(slots)] = True
        placed = [None] * B
        for b, s in zip(slots, seqs):
            placed[b] = s
        codes, n = self._encode(placed, B)
        return self._refill(state, self._t(mask), self._t(codes), self._t(n))

    def _hash(self, pt):
        v = (pt + 2).long()
        N = self.cfg.N
        return ((v * self.Z1[:N]).sum(-1) & MASK32,
                (v * self.Z2[:N]).sum(-1) & MASK32)

    # ---------------- one step for the whole batch
    def candidates(self, state):
        """The first stages of a step: loop analysis, regions, the
        wavefront tables and the lags they rank, and every candidate's
        exact incremental dE.  Returns their tensors by name (step reads
        them; tools/debug_delta.py holds the dE to the integer oracle)."""
        cfg, dp = self.cfg, self.dp
        K, N = cfg.K, cfg.N
        B = self.B
        codes, n, pt = state["codes"], state["n"], state["pt"]
        active, rorder = state["active"], state["rorder"]

        keys = [_kmer_keys(codes, k) for k in (5, 6, 8)]

        # ---- analyze beam, compact regions
        loops = analyze_pt(dp, codes[:, None].expand(B, K, N), pt,
                           n[:, None].expand(B, K))
        rpos, rloc, rslot, mlen = _regions(cfg, pt, loops["enclose"], rorder, n)
        rcodes = torch.where(rpos < N, take(codes, rpos.clamp(0, N - 1)), 0)
        rposc = rpos.clamp(0, N).long()
        z1row, z2row = self.Z1i[rposc], self.Z2i[rposc]

        # ---- correlation + window slide: the wavefront tables; for
        # non-integral weights the FFT correlation ranks the lags
        tabs = wavefront_tables(cfg, self.wtabs, rcodes, rpos, mlen,
                                z1row, z2row)
        if self.integral:
            cor = _lag_norm(cfg, mlen, tabs["cor_raw"][..., : 2 * N - 1])
        else:
            cor = _correlate(cfg, self.W, rcodes, mlen, False)
        lags, lvals = _top_lags(cfg, cor)
        lag_ok = ((lvals > NEG / 2) & (mlen[..., None] >= 2)
                  & active[:, :, None, None])
        li = lags.long()
        ws = {k: tabs[k].gather(-1, li)
              for k in ("max_nb", "max_i", "max_j", "best_sE")}
        hd1 = tabs["hd1"].gather(-1, li).long() & MASK32
        hd2 = tabs["hd2"].gather(-1, li).long() & MASK32

        delta, cplx, has, p0 = _candidate_delta(
            cfg, dp, codes, n, keys, pt, loops, rorder, rpos, ws)
        return dict(rpos=rpos, rloc=rloc, rslot=rslot, mlen=mlen,
                    lag_ok=lag_ok, ws=ws, hd1=hd1, hd2=hd2, delta=delta,
                    cplx=cplx, has=has, p0=p0)

    def step(self, state):
        """One fold step of every lane (fold_jax._seq_step, batched)."""
        cfg, dp, dev = self.cfg, self.dp, self.device
        K, R, M, N, V, S = cfg.K, cfg.R, cfg.M, cfg.N, cfg.V, cfg.S
        B = self.B
        i32 = torch.int32
        codes, n, pt = state["codes"], state["n"], state["pt"]
        energy, active, rorder = state["energy"], state["active"], state["rorder"]
        done = state["done"]

        c = self.candidates(state)
        rpos, rloc, rslot, mlen = c["rpos"], c["rloc"], c["rslot"], c["mlen"]
        lag_ok, ws, hd1, hd2 = c["lag_ok"], c["ws"], c["hd1"], c["hd2"]
        delta, cplx, has, p0 = c["delta"], c["cplx"], c["has"], c["p0"]
        m_ = mlen[..., None]

        # ---- complex candidates: full eval under budget (complex first)
        flat_cplx = (cplx & lag_ok).reshape(B, -1)
        order_c = torch.sort((~flat_cplx).to(torch.uint8), dim=-1,
                             stable=True).indices
        c_idx = order_c[:, : cfg.CPLX]
        c_on = flat_cplx.gather(1, c_idx)
        resolved = torch.zeros_like(flat_cplx).scatter(1, c_idx, c_on)
        delta_flat = delta.reshape(B, -1)
        # c_on is a prefix of every row: evaluate only as far as the
        # longest prefix reaches (the rest would be discarded)
        n_on = int(c_on.sum(1).max())
        if n_on:
            ci, on = c_idx[:, :n_on], c_on[:, :n_on]
            ck = (ci // (R * M)).clamp(0, K - 1)
            cr = (ci // M) % R
            selr = torch.arange(R, device=dev) == cr[..., None]
            cflat = lambda f: f.reshape(B, -1).gather(1, ci)[..., None]
            cand_pts = _combo_pt(
                cfg, pt, rloc, rslot, rpos, ck,
                torch.where(selr, cflat(ws["max_i"]), 0),
                torch.where(selr, cflat(ws["max_j"]), 0),
                torch.where(selr, cflat(ws["max_nb"]), 0), selr)
            cand_E = eval_pt(dp, codes[:, None].expand(B, n_on, N), cand_pts,
                             n[:, None].expand(B, n_on))
            c_delta = cand_E - energy.gather(1, ck)
            delta_flat = delta_flat.scatter(
                1, ci, torch.where(on, c_delta, delta_flat.gather(1, ci)))
        delta = delta_flat.view(B, K, R, M)
        resolved = resolved.view(B, K, R, M)
        dropped = (cplx & lag_ok & ~resolved).sum((1, 2, 3), dtype=i32)

        # ---- acceptance (reference float32 semantics)
        e32 = energy.float()[:, :, None, None]
        dnrj = (e32 + delta.float()) / 100.0 - e32 / 100.0
        usable = has & lag_ok & (~cplx | resolved)
        accept = usable & (dnrj < cfg.min_nrj)

        # ---- per-region candidate order: (dnrj asc, lag-rank asc), and
        # the additive per-candidate quantities in that order
        sort_key = torch.where(accept, dnrj, 3e38)
        ordm = torch.sort(sort_key, dim=-1, stable=True).indices        # [B,K,R,M]
        s_r = accept.sum(-1, dtype=i32)
        lin_c = ws["max_j"] - ws["max_i"] - 1
        i0_c = ws["max_i"] - ws["max_nb"] + 1
        nlive2 = ((lin_c > 0).to(i32)
                  + ((i0_c > 0) | (ws["max_j"] + ws["max_nb"] < m_)).to(i32))
        Dd, Dn, Dh1, Dh2 = (x.gather(-1, ordm)
                            for x in (delta, nlive2, hd1, hd2))

        # ---- windowed combination enumeration (fold_jax :1076-1359)
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

        ph1, ph2 = self._hash(pt)
        kk = torch.arange(K, device=dev)
        vv = torch.arange(V, device=dev)
        rr = torch.arange(R, device=dev)
        z64 = lambda *s: torch.zeros(s, dtype=torch.int64, device=dev)
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
        mode, base, nbr = z64(B), z64(B), z64(B)
        kcap = torch.full((B,), K, dtype=torch.int64, device=dev)
        # one scratch column at S takes the writes of non-new slots
        s_h1 = F.pad(state["seen_h1"], (0, 1))
        s_h2 = F.pad(state["seen_h2"], (0, 1))
        s_cnt = state["seen_cnt"].long()
        bm = dict(valid=zb(B, K), E=torch.full((B, K), INFE, dtype=torch.int64,
                                               device=dev),
                  tie=z64(B, K), kv=z64(B, K), idx=z64(B, K, R),
                  on=zb(B, K, R), h1=z64(B, K), h2=z64(B, K))
        susr, suss = zb(B), zb(B)

        def merge(bm, E, tie, extra):
            """Merge candidate rows into the running top-K beam."""
            E2 = torch.cat([bm["E"], E], 1)
            tie2 = torch.cat([bm["tie"], tie], 1)
            o = _lexsort2(E2, tie2)[:, :K]
            out = dict(E=E2.gather(1, o), tie=tie2.gather(1, o))
            for k, x in extra.items():
                out[k] = _rows(torch.cat([bm[k], x], 1), o)
            return out

        for _ in range(cfg.W):
            run = (mode == M_NORM) & ~done
            if not bool(run.any()):
                break
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
            # more live regions than R slots would drop regions: flag
            r_over = torch.where(on_r, d_nlive, 0).sum(-1) > R
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
            susr_w = susr | (r_over & newmask).any(-1)

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
            susr = torch.where(r3, susr_w, susr)
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
        f_rover = torch.where(part, Dn[..., 0], 0).sum(-1) > R
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
        susr = susr | (f_rover & f_new).any(-1)
        bm = merge(bm, torch.where(f_new, fE, INFE), first_start, dict(
            valid=f_new, kv=kk.expand(B, K), idx=z64(B, K, R),
            on=part, h1=fh1, h2=fh2))

        # exactness flags, one bit per cause
        bits = (_bit((mode == M_NORM) & ~done, FLAG_VWINDOW)
                | _bit(susr, FLAG_RSLOTS) | _bit(suss, FLAG_SEEN))

        # ---- pool (new before old on ties) and truncate to K
        pool_E = torch.cat([torch.where(bm["valid"], bm["E"], INFE),
                            torch.where(active, energy, INFE)], 1)
        tie = torch.cat([bm["tie"], TBIG + kk.expand(B, K)], 1)
        order_p = _lexsort2(pool_E, tie)[:, :K]
        sel_new = order_p < K
        src_new = order_p.clamp(0, K - 1)
        src_old = (order_p - K).clamp(0, K - 1)

        # ---- rebuild the K survivors' pair tables + child region order
        kv_sel = bm["kv"].gather(1, src_new)
        idx_sel = _rows(bm["idx"], src_new)
        on_sel = _rows(bm["on"], src_new)
        cand_sel = take(_rows(ordm, kv_sel), idx_sel[..., None])[..., 0]

        def pick_s(field):
            return take(_rows(field, kv_sel), cand_sel[..., None])[..., 0]

        chi_s, chj_s = pick_s(ws["max_i"]), pick_s(ws["max_j"])
        chr_s, chp0_s = pick_s(ws["max_nb"]), pick_s(p0)
        new_pt_s = _combo_pt(cfg, pt, rloc, rslot, rpos, kv_sel,
                             chi_s, chj_s, chr_s, on_sel)
        par_lab_s = _rows(rorder, kv_sel)
        mlen_s = _rows(mlen, kv_sel)
        inner_ok = on_sel & (chj_s - chi_s - 1 > 0)
        outer_ok = on_sel & (((chi_s - chr_s + 1) > 0) | (chj_s + chr_s < mlen_s))
        lab2 = torch.stack([torch.where(inner_ok, chp0_s, -2),
                            torch.where(outer_ok, par_lab_s, -2)],
                           -1).reshape(B, K, 2 * R)
        key_order = torch.where(lab2 > -2,
                                torch.arange(2 * R, device=dev), 2 * R + 1)
        take_r = torch.sort(key_order, dim=-1, stable=True).indices[..., :R]
        new_ror_s = lab2.gather(-1, take_r)

        s1, s2 = sel_new[:, :, None], sel_new
        beam_pt = torch.where(s1, new_pt_s, _rows(pt, src_old))
        beam_E = torch.where(s2, bm["E"].gather(1, src_new),
                             energy.gather(1, src_old)).to(i32)
        beam_act = torch.where(s2, bm["valid"].gather(1, src_new),
                               active.gather(1, src_old))
        beam_ror = torch.where(s1, new_ror_s, _rows(rorder, src_old))

        # fixed-point check on composed hashes (== _hash of the tables)
        bh1 = torch.where(s2, bm["h1"].gather(1, src_new), ph1.gather(1, src_old))
        unchanged = (((bh1 == ph1) & (beam_act == active))
                     | (~beam_act & ~active)).all(-1)

        keep = ~done
        st = dict(state)
        st.update(
            pt=torch.where(keep[:, None, None], beam_pt, pt),
            energy=torch.where(keep[:, None], beam_E, energy),
            active=torch.where(keep[:, None], beam_act, active),
            rorder=torch.where(keep[:, None, None], beam_ror, rorder),
            seen_h1=s_h1[:, :S], seen_h2=s_h2[:, :S], seen_cnt=s_cnt.to(i32),
            done=done | unchanged,
            cplx_dropped=state["cplx_dropped"] + torch.where(keep, dropped, 0),
            enum_suspect=state["enum_suspect"] | torch.where(keep, bits, 0))
        return st

    @staticmethod
    def flags(st):
        """The FLAG_* cause bitmask of every lane's fold in state `st`."""
        return (st["enum_suspect"] | _bit(st["cplx_dropped"] > 0, FLAG_CPLX)
                | _bit(~st["done"], FLAG_STEPLIM))

    # ---------------- continuous batching
    def _swap(self, st):
        """Lanes whose fold finished (or hit the step limit) bank their
        result into the per-lane output buffer and restart on their
        shadow sequence.  A lane whose buffer is still full waits."""
        LIM = 2 * self.cfg.max_steps
        fin = (st["done"] | (st["lane_steps"] >= LIM)) & (st["seqid"] >= 0)
        rec = fin & st["next_avail"] & ~st["out_valid"]
        m1 = rec[:, None]
        m2 = rec[:, None, None]
        st = dict(st)
        st["out_pt"] = torch.where(m2, st["pt"], st["out_pt"])
        st["out_E"] = torch.where(m1, st["energy"], st["out_E"])
        st["out_act"] = torch.where(m1, st["active"], st["out_act"])
        st["out_n"] = torch.where(rec, st["n"], st["out_n"])
        st["out_seqid"] = torch.where(rec, st["seqid"], st["out_seqid"])
        st["out_done"] = torch.where(rec, st["done"], st["out_done"])
        st["out_flag"] = torch.where(rec, self.flags(st), st["out_flag"])
        st["out_valid"] = st["out_valid"] | rec
        st2 = self._refill(st, rec, st["next_codes"], st["next_n"])
        st2["seqid"] = torch.where(rec, st["next_seqid"], st["seqid"])
        st2["next_avail"] = st["next_avail"] & ~rec
        st2["lane_steps"] = torch.where(rec, 0, st["lane_steps"])
        return st2

    def _runnable(self, st):
        LIM = 2 * self.cfg.max_steps
        fin = st["done"] | (st["lane_steps"] >= LIM)
        swappable = fin & st["next_avail"] & ~st["out_valid"]
        return ((st["seqid"] >= 0) & ~fin) | swappable

    def _advance(self, state, G: int):
        """Up to G swap+step rounds (early exit when no lane can make
        progress), then a final swap so folds that finished on the last
        step are visible in the output buffers."""
        for _ in range(G):
            if not bool(self._runnable(state).any()):
                break
            state = self.step(self._swap(state))
            state["lane_steps"] = state["lane_steps"] + (~state["done"]).to(torch.int32)
        return self._swap(state)

    def _drain_load(self, state, clear, load, codes_new, n_new, sid_new):
        st = dict(state)
        st["out_valid"] = st["out_valid"] & ~clear
        st["next_codes"] = torch.where(load[:, None], codes_new, st["next_codes"])
        st["next_n"] = torch.where(load, n_new, st["next_n"])
        st["next_seqid"] = torch.where(load, sid_new, st["next_seqid"])
        st["next_avail"] = st["next_avail"] | load
        return st

    _OUT_KEYS = ("out_pt", "out_E", "out_act", "out_n", "out_seqid",
                 "out_done", "out_flag", "out_valid", "done", "seqid",
                 "lane_steps")

    def run_stream(self, seqs, G: int = 4):
        """Continuous-batching fold over a sequence list.

        Yields (index, rows, flagged) as folds finish, where rows is the
        final beam [(dot_bracket, energy_kcal)] best-first and flagged
        the FLAG_* cause bitmask.  Finished lanes swap onto preloaded
        shadow sequences between steps; the host drains banked results
        and reloads shadows every G steps.  Every state update builds new
        tensors and drops the old ones at once (what buffer donation buys
        the JAX engine)."""
        cfg, B = self.cfg, self.B
        nseq = len(seqs)
        state = self.init_state(seqs[:B], seqids=list(range(min(B, nseq))))
        nxt = min(B, nseq)

        def loader(lanes):
            nonlocal nxt
            load = np.zeros(B, bool)
            placed = [None] * B
            sid = np.full(B, -1, np.int32)
            for b in lanes:
                if nxt < nseq:
                    placed[b], sid[b], load[b] = seqs[nxt], nxt, True
                    nxt += 1
            codes, n = self._encode(placed, B)
            return load, codes, n, sid

        load, codes_new, n_new, sid_new = loader(range(B))
        state = self._drain_load(state, self._t(np.zeros(B, bool)),
                                 self._t(load), self._t(codes_new),
                                 self._t(n_new), self._t(sid_new))
        emitted = 0
        while emitted < nseq:
            state = self._advance(state, G)
            (o_pt, o_E, o_act, o_n, o_sid, o_done, o_flag, o_valid,
             l_done, l_sid, l_steps) = (state[k].cpu().numpy()
                                        for k in self._OUT_KEYS)
            fresh = np.where(o_valid)[0]
            clear = np.zeros(B, bool)
            for b in fresh:
                rows = self._rows_from(o_pt[b], o_E[b], o_act[b], o_n[b])
                yield int(o_sid[b]), rows, int(o_flag[b]) | (
                    0 if o_done[b] else FLAG_STEPLIM)
                emitted += 1
                clear[b] = True
            load, codes_new, n_new, sid_new = loader(fresh)
            if clear.any() or load.any():
                state = self._drain_load(
                    state, self._t(clear), self._t(load), self._t(codes_new),
                    self._t(n_new), self._t(sid_new))
            elif len(fresh) == 0:
                # end-game: no banked results and no shadows left —
                # remaining folds finish in live lanes
                LIM = 2 * cfg.max_steps
                live = (l_sid >= 0) & (l_done | (l_steps >= LIM))
                if not live.any():
                    continue
                pt_l, E_l, act_l, n_l, cd_l, es_l = (
                    state[k].cpu().numpy() for k in
                    ("pt", "energy", "active", "n", "cplx_dropped",
                     "enum_suspect"))
                kill = np.zeros(B, bool)
                for b in np.where(live)[0]:
                    rows = self._rows_from(pt_l[b], E_l[b], act_l[b], n_l[b])
                    yield (int(l_sid[b]), rows,
                           int(es_l[b]) | (FLAG_CPLX if cd_l[b] > 0 else 0)
                           | (0 if l_done[b] else FLAG_STEPLIM))
                    emitted += 1
                    kill[b] = True
                # retire emitted lanes (an empty sequence, seqid -1)
                killt = self._t(kill)
                state = self._refill(state, killt,
                                     torch.zeros_like(state["codes"]),
                                     torch.zeros_like(state["n"]))
                state["seqid"] = torch.where(killt, -1, state["seqid"])

    def _rows_from(self, pt_k, E_k, act_k, n_b):
        rows = []
        for k in range(self.cfg.K):
            if not act_k[k]:
                continue
            pairs = [(i, int(pt_k[k, i])) for i in range(n_b) if pt_k[k, i] > i]
            rows.append((dot_bracket(pairs, int(n_b)),
                         float(np.float32(int(E_k[k]) / 100.0))))
        return rows

    # ---------------- host API
    def run(self, seqs, collect_traj=False):
        state = self.init_state(seqs)
        traj = []
        for _ in range(self.cfg.max_steps):
            if bool(state["done"].all()):
                break
            if collect_traj:
                traj.append(self._beams(state, len(seqs)))
            state = self.step(state)
        beams = self._beams(state, len(seqs))
        if collect_traj:
            return beams, traj, state
        return beams, state

    def _beams(self, state, nseq):
        pt, E, act, n = (state[k].cpu().numpy()
                         for k in ("pt", "energy", "active", "n"))
        return [self._rows_from(pt[b], E[b], act[b], n[b]) for b in range(nseq)]


def fold_one_config(n, nb_mode=100, max_stack=1, max_branch=100, min_hp=3,
                    min_nrj=0.0, temp=37.0, gc_wei=3.0, au_wei=2.0,
                    gu_wei=1.0) -> EngineConfig:
    """The configuration fold_one folds a sequence of n nt at."""
    N = 1 << max(5, int(np.ceil(np.log2(max(8, n)))))
    return EngineConfig(N=N, K=max_stack, M=min(nb_mode, 2 * N - 1),
                        max_branch=max_branch,
                        min_hp=min_hp, min_nrj=min_nrj, temp=temp,
                        gc_wei=gc_wei, au_wei=au_wei, gu_wei=gu_wei,
                        V=min(4096, max(256, 2 * max_branch)),
                        S=max(4096, 16 * max_stack * 8),
                        R=16 if N <= 512 else 32)


def _fold_one(sequence, nb_mode, max_stack, max_branch, min_hp, min_nrj,
              traj, temp, gc_wei, au_wei, gu_wei, device):
    """fold_one's results and the fold's FLAG_* bitmask."""
    cfg = fold_one_config(len(sequence), nb_mode, max_stack, max_branch,
                          min_hp, min_nrj, temp, gc_wei, au_wei, gu_wei)
    eng = FoldEngine(cfg, B=1, device=device)
    mk = lambda rows: [Structure([], [], e, db) for db, e in rows]
    if traj:
        beams, steps, state = eng.run([sequence], collect_traj=True)
        out = (mk(beams[0]), [mk(s[0]) for s in steps])
    else:
        beams, state = eng.run([sequence])
        out = mk(beams[0])
    return out, int(eng.flags(state)[0])


def fold_one(sequence, nb_mode=100, max_stack=1, max_branch=100, min_hp=3,
             min_nrj=0.0, traj=False, temp=37.0, gc_wei=3.0, au_wei=2.0,
             gu_wei=1.0, *, device="cuda"):
    """Single-sequence API on the batched engine (reference fold()
    signature plus the device to run on).  A flagged fold is returned as
    the engine made it, and a configuration the engine refuses raises
    (engine_refusal): `fold` sends both to the CPU parity engine."""
    return _fold_one(sequence, nb_mode, max_stack, max_branch, min_hp,
                     min_nrj, traj, temp, gc_wei, au_wei, gu_wei, device)[0]


def flag_names(flag: int) -> str:
    return "+".join(c for b, c in FLAG_NAMES.items() if flag & b) or "none"


# fold() calls answered by fold_cpu: folds the engine flagged, and inputs
# the engine refuses
REFOLDS = 0


def fold(sequence, nb_mode=100, max_stack=1, max_branch=100, min_hp=3,
         min_nrj=0.0, traj=False, temp=37.0, gc_wei=3.0, au_wei=2.0,
         gu_wei=1.0, *, device="cuda"):
    """The package's `fold`: rafft_tpu.fold's signature and results, the
    final beam (and the trajectory with traj=True), plus the device.

    Folds on the batched engine at fold_one's configuration, except where
    the sequential CPU parity engine (fold_cpu, what rafft_tpu.fold runs)
    must answer instead:

    - inputs the engine refuses (engine_refusal): max_stack > 255 (the
      pool's tie order), min_hp < 0 (the wavefront tables' padding) and
      sequences over 4,096 nt (MAX_N, the largest bucket); no engine is
      built for them;
    - folds the engine flags as possibly inexact (a FLAG_* bit), as
      sweep() refolds them.

    Either is logged at INFO with its reason and counted in REFOLDS.  So
    the result equals rafft_tpu.fold's on every input."""
    global REFOLDS
    args = (nb_mode, max_stack, max_branch, min_hp, min_nrj, traj, temp,
            gc_wei, au_wei, gu_wei)
    reason = engine_refusal(fold_one_config(
        len(sequence), nb_mode, max_stack, max_branch, min_hp, min_nrj, temp,
        gc_wei, au_wei, gu_wei))
    if reason is None:
        out, flag = _fold_one(sequence, *args, device)
        if not flag:
            return out
        reason = f"the engine flagged the fold ({flag_names(flag)})"
    from rafft_tpu_torch.engine import fold_cpu

    _LOG.info("fold: a %d-nt fold goes to fold_cpu: %s", len(sequence),
              reason)
    REFOLDS += 1
    return fold_cpu.fold(sequence, *args)
