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
* every candidate's exact dE (the stage delta) comes from
  engine/delta.py: the CUDA kernel csrc/delta.cu on the card, its plain
  version (fold_jax._candidate_delta's semantics on the lanes) on the
  CPU;
* lookups are plain gathers: no one-hot einsums, no lane compaction and
  no f32 packing of dE / hash halves (dE, live-region counts and hashes
  stay integer tensors; hashes are uint32 values held in int64);
* the combination enumeration (the stage enumerate) comes from
  engine/enumerate.py: on the card the CUDA kernel csrc/enumerate.cu, one
  block per lane, which runs the lane's windows in order and leaves the
  loop once the lane has finished; on the CPU its plain version, a Python
  loop over all W windows in which all lanes advance together and a
  per-lane mask freezes the lanes that have finished (a window with no
  lane left to run leaves the state bit for bit as it was); the complex
  candidates are evaluated at the fixed width CPLX.  So no stage of a
  step reads the device and every shape in it is fixed by the
  configuration;
* what jax.jit gives the JAX engine, a CUDA graph gives this one: on a
  card, run_stream replays one graph of G swap+step rounds
  (_advance_graphed, the counterpart of the jitted _advance_impl) and
  run one graph of G steps (_steps, the jitted _steps_impl), captured once per
  engine and G on static state buffers, with one private memory pool per
  engine.  graphs=False runs the same code eagerly (the CPU path, and
  the plain version the graphs are held to).  fold and fold_one keep
  their engines between calls (_kept_engine), as the jitted programs
  stay compiled;
* a fold of run_stream leaves the card one way only: the graph's swap
  banks it, with its flags, into the lane's output buffer, which the
  host reads once per replay.  When the draw is exhausted a lane gets an
  empty shadow sequence, so its last fold is banked the same way, a
  fold at the step limit at that limit; the JAX engine's host reads
  such lanes' live state after the replay and retires them itself.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from rafft_tpu_torch import _build, obs
from rafft_tpu_torch.energy.params import encode_sequence
from rafft_tpu_torch.scan.correlate import correlate_fft
from rafft_tpu_torch.scan.encode import weight_matrix
from rafft_tpu_torch.struct import Structure, dot_bracket
from rafft_tpu_torch.energy.eval_torch import (_kmer_keys, analyze_pt,
                                               device_params, eval_pt, take)
from rafft_tpu_torch.engine import wavefront as WT
# the stage delta: the wrapper, and its plain version for the tools
from rafft_tpu_torch.engine.delta import (_candidate_delta,  # noqa: F401
                                          _children, candidate_delta)
# the stage enumerate, and the helpers and constants the pool shares
from rafft_tpu_torch.engine.enumerate import (INFE, M_NORM, MASK32,
                                              _lexsort2, _rows,
                                              enumerate_combos)
from rafft_tpu_torch.engine.wavefront import small_tables, wavefront_tables

_LOG = logging.getLogger(__name__)
NEG = float(np.float32(-3.0e38))

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

# the stages of a fold step, as its stage clock names them (obs):
# swap (continuous batching, _advance only), loop analysis and regions,
# the wavefront tables and the lags they rank, the candidates' dE, the
# complex candidates' full evaluation, the combination enumeration, and
# the pool with the survivors' rebuild
STAGES = ("swap", "loops", "wavefront", "delta", "complex", "enumerate",
          "pool")

TBIG = 1 << 28
# the longest padded length the engine folds (the largest bucket of the
# sweep).  What grows with N was audited up to it: the (depth, position)
# sort keys of eval_torch._enclose and the hash sums are int64, the
# Zobrist tables have N + 1 entries, flat gather indices are int64,
# CLAMP (engine/enumerate.py) and TBIG bound combination counts, which do
# not depend on N, and the loop-size tables of energy/params.py reach
# 8,192 unpaired positions
MAX_N = 4096
# the state keys that the JAX engine's state lacks: each lane's most
# complex candidates in any step of its fold and the most live regions of
# any new structure it considered, and the banked fold's; and each lane's
# running totals of the enumeration windows it ran and of the steps in
# which it enumerated (never reset)
PORT_KEYS = ("cplx_need", "out_cplx_need", "r_need", "out_r_need",
             "enum_windows", "enum_steps")


def cplx_budget(base: int, K: int) -> int:
    """The complex-candidate budget CPLX at beam width K: `base` per 50
    beam rows begun, so K <= 50 keeps `base`.  A step offers K*R*M
    candidates per lane, so a wider beam has proportionally more complex
    ones to evaluate (a deliberate difference from the JAX sweep, whose
    CPLX does not grow with K)."""
    return base * -(-K // 50)


def region_slots(N: int) -> int:
    """The region slots R of the N bucket: the JAX sweep's 16 up to
    N=256 and 32 above 512.  At 512 that sweep's 16 drop regions of two
    of the corpus's 252 rows of 257-512 nt at -n 100 -ms 50 (flag
    r_slots); the band's largest r_need is 20 live regions at K=50 and
    24 at K=200 (journal row 2269), so the 512 bucket takes 24 (a
    deliberate difference from the JAX sweep).  R does not grow with K:
    at K=200 the band fills every slot, so a wider beam or another
    corpus may need more, and run_stream's needs say so."""
    return 16 if N <= 256 else 24 if N <= 512 else 32


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

def _bit(mask, flag):
    return mask.to(torch.int32) * flag


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
    (fold_jax._correlate).  W as correlate_fft takes it."""
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
    """Batched fold engine for one (config, batch size, device).

    graphs (default: on a CUDA device) makes run_stream and run replay
    CUDA graphs (_advance_graphed; _graphed of _steps); graphs=False runs the
    same steps eagerly, op by op.  The CPU has no graphs."""

    def __init__(self, cfg: EngineConfig, B: int, device="cuda", graphs=None):
        with obs.span("engine.build"):
            refusal = engine_refusal(cfg)
            if refusal is not None:
                raise ValueError(refusal)
            self.cfg = cfg
            self.B = B
            self.device = torch.device(device)
            if graphs is None:
                graphs = self.device.type == "cuda"
            if graphs and self.device.type != "cuda":
                raise ValueError(
                    f"CUDA graphs need a CUDA device, not {device}")
            self.graphs = bool(graphs)
            self.dp = device_params(cfg.temp, cfg.N, self.device)
            self.W = weight_matrix(cfg.gc_wei, cfg.au_wei, cfg.gu_wei)
            self.integral = _weights_integral(cfg)
            # the kernel's lookup tables and the FFT correlation's weights,
            # uploaded once (not per step)
            self.wtabs = small_tables(self.dp, self.W, self.device)
            self.fft_W = torch.as_tensor(np.asarray(self.W, np.float32),
                                         device=self.device)
            # the kernel's seven output tables, allocated at the first step;
            # the layout contract is checked once, on that step
            self._tables_out = None
            self._layout_checked = False
            # CUDA graphs: one per (kind, G), on the static state buffers,
            # all in one private memory pool (see _graphed)
            self._graphs = {}
            self._static = None
            self._pool = None
            # Zobrist coefficients: the same draws as fold_jax, so hashes and
            # seen-sets equal the JAX engine's
            rng = np.random.default_rng(0xA5F7)
            z1 = rng.integers(1, 2**32 - 1, cfg.N + 1,
                              dtype=np.uint64).astype(np.uint32)
            z2 = rng.integers(1, 2**32 - 1, cfg.N + 1,
                              dtype=np.uint64).astype(np.uint32)
            dev = self.device
            self.Z1 = torch.as_tensor(z1.astype(np.int64), device=dev)
            self.Z2 = torch.as_tensor(z2.astype(np.int64), device=dev)
            self.Z1i = torch.as_tensor(z1.view(np.int32), device=dev)
            self.Z2i = torch.as_tensor(z2.view(np.int32), device=dev)
            # the step's stage clock (a capture puts its own in its place),
            # and the stage clocks of graph replays that no host read has
            # waited for yet
            self._stages = obs.HostStages()
            self._pending = {}

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
            cplx_need=z(B), r_need=z(B), enum_windows=z(B), enum_steps=z(B),
            # continuous batching: per-lane shadow sequence, output buffer
            # for one finished fold, and bookkeeping
            seqid=self._t(sid), lane_steps=z(B),
            next_codes=z(B, N), next_n=z(B), next_seqid=f(-1, B),
            next_avail=z(B, d=torch.bool),
            out_pt=f(-1, B, K, N), out_E=z(B, K),
            out_act=z(B, K, d=torch.bool), out_n=z(B), out_seqid=f(-1, B),
            out_done=z(B, d=torch.bool), out_flag=z(B),
            out_valid=z(B, d=torch.bool), out_cplx_need=z(B),
            out_r_need=z(B),
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
        # -1 (the exterior region) at [0, 0], -2 elsewhere; built on the
        # device, as a capture needs (an item assignment copies from the host)
        flat = torch.arange(K * R, device=dev).view(K, R)
        root_rorder = torch.where(flat == 0, -1, -2).to(torch.int32)
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
        st["cplx_need"] = torch.where(mask, 0, state["cplx_need"])
        st["r_need"] = torch.where(mask, 0, state["r_need"])
        st["enum_suspect"] = torch.where(mask, 0, state["enum_suspect"])
        return st

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
        them; tools/debug_delta.py holds the dE to the integer oracle).
        Marks the stages loops, wavefront and delta (obs), and ends the
        last unless a caller's stage was open."""
        cfg, dp = self.cfg, self.dp
        K, N = cfg.K, cfg.N
        B = self.B
        codes, n, pt = state["codes"], state["n"], state["pt"]
        active, rorder = state["active"], state["rorder"]
        clock = self._stages
        own = clock.idle
        clock.to("loops")

        keys = [_kmer_keys(codes, k) for k in (5, 6, 8)]

        # ---- analyze beam, compact regions
        loops = analyze_pt(dp, codes[:, None].expand(B, K, N), pt,
                           n[:, None].expand(B, K))
        rpos, rloc, rslot, mlen = _regions(cfg, pt, loops["enclose"], rorder, n)
        rcodes = torch.where(rpos < N, take(codes, rpos.clamp(0, N - 1)), 0)
        rposc = rpos.clamp(0, N).long()
        z1row, z2row = self.Z1i[rposc], self.Z2i[rposc]
        clock.to("wavefront")

        # ---- correlation + window slide: the wavefront tables; for
        # non-integral weights the FFT correlation ranks the lags
        args = (cfg, self.wtabs, rcodes, rpos, mlen, z1row, z2row)
        if not self._layout_checked:
            # one host read on the engine's first step, before any capture
            WT.check_layout(*args)
            self._layout_checked = True
        if rcodes.is_cuda:
            if self._tables_out is None:
                self._tables_out = WT.empty_tables(rcodes.shape, rcodes.device)
            tabs = wavefront_tables(*args, out=self._tables_out)
        else:
            tabs = wavefront_tables(*args)
        if self.integral:
            cor = _lag_norm(cfg, mlen, tabs["cor_raw"][..., : 2 * N - 1])
        else:
            cor = _correlate(cfg, self.fft_W, rcodes, mlen, False)
        lags, lvals = _top_lags(cfg, cor)
        lag_ok = ((lvals > NEG / 2) & (mlen[..., None] >= 2)
                  & active[:, :, None, None])
        li = lags.long()
        ws = {k: tabs[k].gather(-1, li)
              for k in ("max_nb", "max_i", "max_j", "best_sE")}
        hd1 = tabs["hd1"].gather(-1, li).long() & MASK32
        hd2 = tabs["hd2"].gather(-1, li).long() & MASK32
        clock.to("delta")

        delta, cplx, has, p0 = candidate_delta(
            cfg, dp, codes, n, keys, pt, loops, rorder, rpos, ws)
        if own:
            clock.to(None)
        return dict(rpos=rpos, rloc=rloc, rslot=rslot, mlen=mlen,
                    lag_ok=lag_ok, ws=ws, hd1=hd1, hd2=hd2, delta=delta,
                    cplx=cplx, has=has, p0=p0)

    def complex_delta(self, state, c, width=None):
        """The complex candidates' dE by full evaluation under the CPLX
        budget, complex first (fold_jax._seq_step): returns the dE of
        every candidate [B,K,R,M] and which complex ones were resolved.

        Every row evaluates `width` candidates, the whole budget CPLX by
        default, as the JAX engine does: a fixed shape, whatever each
        row's count of complex candidates; the entries past a row's
        complex prefix are masked.  A smaller width serves
        tools/measure.py, which times the fixed width against the longest
        prefix that a step needs."""
        cfg, dp, dev = self.cfg, self.dp, self.device
        K, R, M, N = cfg.K, cfg.R, cfg.M, cfg.N
        B = self.B
        codes, n, pt, energy = (state[k] for k in ("codes", "n", "pt",
                                                   "energy"))
        ws, delta = c["ws"], c["delta"]
        flat_cplx = (c["cplx"] & c["lag_ok"]).reshape(B, -1)
        order_c = torch.sort((~flat_cplx).to(torch.uint8), dim=-1,
                             stable=True).indices
        ci = order_c[:, : cfg.CPLX]
        on = flat_cplx.gather(1, ci)
        resolved = torch.zeros_like(flat_cplx).scatter(1, ci, on)
        if width is not None:
            ci, on = ci[:, :width], on[:, :width]
        X = ci.shape[1]
        if X == 0:
            return delta, resolved.view(B, K, R, M)
        ck = (ci // (R * M)).clamp(0, K - 1)
        cr = (ci // M) % R
        selr = torch.arange(R, device=dev) == cr[..., None]
        cflat = lambda f: f.reshape(B, -1).gather(1, ci)[..., None]
        cand_pts = _combo_pt(
            cfg, pt, c["rloc"], c["rslot"], c["rpos"], ck,
            torch.where(selr, cflat(ws["max_i"]), 0),
            torch.where(selr, cflat(ws["max_j"]), 0),
            torch.where(selr, cflat(ws["max_nb"]), 0), selr)
        cand_E = eval_pt(dp, codes[:, None].expand(B, X, N), cand_pts,
                         n[:, None].expand(B, X))
        c_delta = cand_E - energy.gather(1, ck)
        delta_flat = delta.reshape(B, -1)
        delta_flat = delta_flat.scatter(
            1, ci, torch.where(on, c_delta, delta_flat.gather(1, ci)))
        return delta_flat.view(B, K, R, M), resolved.view(B, K, R, M)

    def step(self, state):
        """One fold step of every lane (fold_jax._seq_step, batched).
        Marks its stages on the engine's stage clock (STAGES but swap) and
        counts its round there; ends its last stage unless the caller's
        stage was open (_advance's swap)."""
        cfg, dev = self.cfg, self.device
        K, R = cfg.K, cfg.R
        B = self.B
        i32 = torch.int32
        pt = state["pt"]
        energy, active, rorder = state["energy"], state["active"], state["rorder"]
        done = state["done"]
        clock = self._stages
        own = clock.idle
        clock.to("loops")

        c = self.candidates(state)
        rpos, rloc, rslot, mlen = c["rpos"], c["rloc"], c["rslot"], c["mlen"]
        lag_ok, ws, hd1, hd2 = c["lag_ok"], c["ws"], c["hd1"], c["hd2"]
        cplx, has, p0 = c["cplx"], c["has"], c["p0"]
        m_ = mlen[..., None]
        clock.to("complex")

        delta, resolved = self.complex_delta(state, c)
        dropped = (cplx & lag_ok & ~resolved).sum((1, 2, 3), dtype=i32)
        need = (cplx & lag_ok).sum((1, 2, 3), dtype=i32)
        clock.to("enumerate")

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

        # ---- windowed combination enumeration (fold_jax :1076-1359):
        # engine/enumerate.py, the kernel csrc/enumerate.cu on the card
        ph1, ph2 = self._hash(pt)
        e, bm = enumerate_combos(cfg, Dd, Dn, Dh1, Dh2, s_r, energy, ph1, ph2,
                                 done, state["seen_h1"], state["seen_h2"],
                                 state["seen_cnt"])
        mode, rneed, suss = e["mode"], e["rneed"], e["suss"]

        # exactness flags, one bit per cause
        bits = (_bit((mode == M_NORM) & ~done, FLAG_VWINDOW)
                | _bit(rneed > R, FLAG_RSLOTS) | _bit(suss, FLAG_SEEN))

        clock.to("pool")
        # ---- pool (new before old on ties) and truncate to K
        kk = torch.arange(K, device=dev)
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
            seen_h1=e["seen_h1"], seen_h2=e["seen_h2"],
            seen_cnt=e["seen_cnt"].to(i32),
            done=done | unchanged,
            cplx_dropped=state["cplx_dropped"] + torch.where(keep, dropped, 0),
            cplx_need=torch.maximum(state["cplx_need"],
                                    torch.where(keep, need, 0)),
            r_need=torch.maximum(state["r_need"],
                                 torch.where(keep, rneed, 0).to(i32)),
            enum_suspect=state["enum_suspect"] | torch.where(keep, bits, 0),
            enum_windows=state["enum_windows"] + e["windows"],
            enum_steps=state["enum_steps"] + keep.to(i32))
        clock.round()
        if own:
            clock.to(None)
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
        st["out_cplx_need"] = torch.where(rec, st["cplx_need"],
                                          st["out_cplx_need"])
        st["out_r_need"] = torch.where(rec, st["r_need"], st["out_r_need"])
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
        """G swap+step rounds, then a final swap so folds that finished on
        the last step are visible in the output buffers
        (fold_jax._advance_impl).  No host read: a round in which no lane
        can make progress leaves the whole state as it was, as the JAX
        while_loop stops there.  The test is batch-wide, as that loop's
        condition is: while any lane is runnable, every lane steps.  The
        stage swap (obs) holds the gate, the swaps and the merge."""
        clock = self._stages
        for _ in range(G):
            clock.to("swap")
            go = self._runnable(state).any()
            nxt = self.step(self._swap(state))
            clock.to("swap")
            nxt["lane_steps"] = nxt["lane_steps"] + (~nxt["done"]).to(torch.int32)
            state = {k: torch.where(go, nxt[k], v) for k, v in state.items()}
        state = self._swap(state)
        clock.to(None)
        return state

    def _steps(self, state, G: int):
        """G fold steps (fold_jax._steps_impl).  A step of a lane that is
        done leaves it as it was, so no early exit is needed."""
        for _ in range(G):
            state = self.step(state)
        return state

    # ---------------- CUDA graphs
    def _graphed(self, body, state, G: int):
        """body(state, G), self._advance or self._steps, replayed as one
        CUDA graph: the state is copied into the
        engine's static buffers (only the tensors that are not those
        buffers already) and the graph, captured at its first use, runs
        the G rounds on them with no host read and writes the result back
        into them.  Returns a dict of the static buffers: the next replay
        overwrites them.

        The graph of each (body, G) is captured once per engine, so the
        cache key is (N, B, K, M, R, V, S, CPLX, ..., G): the engine's
        whole configuration and batch size.  Before its capture, one round
        runs eagerly on a side stream (the warm-up: the kernel's library,
        cuFFT's plans and the layout check are made there).  All graphs of
        an engine share one private memory pool: each keeps nothing live
        in it between replays (its outputs are copied into the static
        buffers), and the engine's graphs never run at the same time.
        A capture that fails raises; nothing falls back to the eager
        path.  The replay's stage clock waits for the next host read
        (_read_stages), which adds it to the trace if the profiler
        records then: a replay launched just before the profiler starts
        is read by the read that waits for it."""
        with obs.span("engine.copy_in"):
            if self._static is None:
                self._static = {k: v.clone() for k, v in state.items()}
            st = self._static
            if state.keys() != st.keys():
                raise ValueError("the state's keys differ from the graph's")
            for k, v in state.items():
                if v is not st[k]:
                    st[k].copy_(v)
        key = (body.__name__, G)
        if key not in self._graphs:
            self._graphs[key] = self._capture(body, G)
        graph, launches, stages = self._graphs[key]
        with obs.span("engine.launch"):
            graph.replay()
        for kernel, n in launches.items():
            kernel.count_replay(n)
        self._pending[key] = stages
        return dict(st)

    def _capture(self, body, G):
        """Warm up, then capture body(static state, G) and its copy back
        into the static buffers.  Returns (graph, {hand kernel
        (_build.KERNELS): its launches in the graph}, its stage clock:
        obs.GraphStages, whose timing events the graph records at every
        replay, whether or not the profiler records; the copy back is
        timed with the body's last stage, the final swap or the pool)."""
        st = self._static
        with obs.span("engine.warmup"):
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                body(dict(st), 1)
            cur.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = {kernel: kernel.captured for kernel in _build.KERNELS}
        host, stages = self._stages, obs.GraphStages()
        self._stages = stages
        try:
            with obs.span("engine.capture"), \
                    torch.cuda.graph(graph, pool=self._pool):
                out = body(dict(st), G)
                stages.resume()
                for k, v in st.items():
                    v.copy_(out[k])
                stages.to(None)
                del out      # nothing of the capture stays live in the pool
        finally:
            self._stages = host
        launches = {kernel: kernel.captured - n
                    for kernel, n in before.items()}
        return graph, launches, stages

    def _read_stages(self):
        """After a host read that waited for the replays since the last
        one: add their stages' device ms to the trace (obs), while the
        profiler records."""
        if self._pending:
            pending, self._pending = self._pending, {}
            if obs.recording():
                for stages in pending.values():
                    stages.read()

    def _advance_graphed(self, state, G: int):
        """_advance(state, G) as one CUDA graph replay (see _graphed)."""
        return self._graphed(self._advance, state, G)

    def _drain_load(self, state, clear, load, codes_new, n_new, sid_new):
        with obs.span("stream.load"):
            st = dict(state)
            st["out_valid"] = st["out_valid"] & ~clear
            st["next_codes"] = torch.where(load[:, None], codes_new,
                                           st["next_codes"])
            st["next_n"] = torch.where(load, n_new, st["next_n"])
            st["next_seqid"] = torch.where(load, sid_new, st["next_seqid"])
            st["next_avail"] = st["next_avail"] | load
            return st

    _OUT_KEYS = ("out_pt", "out_E", "out_act", "out_n", "out_seqid",
                 "out_flag", "out_cplx_need", "out_r_need", "out_valid",
                 "done", "seqid", "lane_steps", "enum_windows", "enum_steps")

    def run_stream(self, seqs, G: int = 4, needs=None):
        """Continuous-batching fold over a sequence list.

        Yields (index, rows, flagged) as folds finish, where rows is the
        final beam [(dot_bracket, energy_kcal)] best-first and flagged
        the FLAG_* cause bitmask (flags()); `needs`, a dict where given,
        gets each yielded fold's (cplx_need, r_need) under its index: the
        most complex candidates any step of it had (it overflowed the
        budget CPLX where above it), and the most live regions of any new
        structure it considered (over R it dropped regions).

        Every lane that folds a sequence holds a shadow: the draw's next
        sequence, or once the draw is exhausted an empty one (n 0, seqid
        -1).  Between steps, a lane whose fold finished (or hit the step
        limit) banks it into its output buffer with its flags and
        restarts on its shadow (_swap); a lane restarted on an empty
        shadow folds nothing more.  Every G steps the host reads the
        output buffers and the lanes' done, seqid and lane_steps in one
        host read (_fetch), clears those buffers and loads the banked
        lanes' next shadows (_drain_load), launches the next G steps
        while folds remain, and only then formats and yields each banked
        fold from the host copies, while the card steps.  So every fold
        leaves by the output buffers, and the host edits the state only
        there.  A consumer that stops early leaves at most one launch in
        flight, on the engine's stream, which the next use orders after.
        On a card (graphs) the G steps are one CUDA graph replay on the
        engine's static state buffers, which the host's updates are
        copied into; else every state update builds new tensors and
        drops the old ones at once (what buffer donation buys the JAX
        engine).

        Traced (obs): the spans engine.rows (a fold's rows),
        stream.encode and stream.load of the host's drain, and the
        counters stream.replays, stream.rounds, stream.ahead (a launch
        after a read and before that read's yields: stream.replays - 1
        over a draw consumed whole), stream.folds,
        stream.flagged (folds with a flag bit) and stream.flagged.<cause>
        (each bit by its FLAG_NAMES name), and after each read
        stream.live_lanes (lanes folding a sequence, neither done nor at
        the step limit) of stream.lanes; the high-water counters
        stream.cplx_need_peak (the largest cplx_need of the folds
        yielded) and stream.cplx_budget (CPLX), stream.rslot_need_peak
        (the largest r_need) and stream.rslots (R); and after each read
        stream.enum_windows and stream.enum_steps, what the lanes'
        running totals enum_windows (enumeration windows run) and
        enum_steps (steps that enumerated) rose by since the last read."""
        cfg, B = self.cfg, self.B
        LIM = 2 * cfg.max_steps
        nseq = len(seqs)
        seqid = np.arange(B)
        seqid[nseq:] = -1
        state = self.init_state(seqs[:B], seqids=seqid[:nseq])
        nxt = min(B, nseq)

        def loader(lanes, seqid):
            """Shadows for `lanes`, whose shadow slots are free: the
            draw's next sequences, then an empty one for each lane that
            still folds a sequence (seqid >= 0), so that the graph banks
            that fold; a lane that folds none gets none."""
            nonlocal nxt
            load = np.zeros(B, bool)
            placed = [None] * B
            sid = np.full(B, -1, np.int32)
            for b in lanes:
                if nxt < nseq:
                    placed[b], sid[b], load[b] = seqs[nxt], nxt, True
                    nxt += 1
                else:
                    load[b] = seqid[b] >= 0
            with obs.span("stream.encode"):
                codes, n = self._encode(placed, B)
            return load, codes, n, sid

        def tally(sid, flag, need, r_need):
            if needs is not None:
                needs[sid] = (need, r_need)
            if obs.recording():
                obs.count("stream.folds")
                obs.count("stream.flagged", int(flag != 0))
                for bit, cause in FLAG_NAMES.items():
                    if flag & bit:
                        obs.count("stream.flagged." + cause)
                obs.high("stream.cplx_need_peak", need)
                obs.high("stream.rslot_need_peak", r_need)

        load, codes_new, n_new, sid_new = loader(range(B), seqid)
        state = self._drain_load(state, self._t(np.zeros(B, bool)),
                                 self._t(load), self._t(codes_new),
                                 self._t(n_new), self._t(sid_new))
        advance = self._advance_graphed if self.graphs else self._advance
        emitted = 0
        # the lanes' enumeration totals at the last read
        enum_seen = np.zeros((2, B), np.int64)
        if nseq:
            state = advance(state, G)
        while emitted < nseq:
            (o_pt, o_E, o_act, o_n, o_sid, o_flag, o_need, o_rneed, o_valid,
             l_done, l_sid, l_steps, l_windows, l_enums) = self._fetch(
                 state, self._OUT_KEYS)
            enum_now = np.stack([l_windows, l_enums]).astype(np.int64)
            enum_new, enum_seen = (enum_now - enum_seen).sum(1), enum_now
            if obs.recording():
                obs.high("stream.cplx_budget", cfg.CPLX)
                obs.high("stream.rslots", cfg.R)
                obs.count("stream.replays")
                obs.count("stream.rounds", G)
                live = (l_sid >= 0) & ~l_done & (l_steps < LIM)
                obs.count("stream.live_lanes", int(live.sum()))
                obs.count("stream.lanes", B)
                obs.count("stream.enum_windows", int(enum_new[0]))
                obs.count("stream.enum_steps", int(enum_new[1]))
            fresh = np.flatnonzero(o_valid)
            if len(fresh):
                load, codes_new, n_new, sid_new = loader(fresh, l_sid)
                state = self._drain_load(
                    state, self._t(o_valid), self._t(load),
                    self._t(codes_new), self._t(n_new), self._t(sid_new))
            if emitted + len(fresh) < nseq:
                # the fetched arrays are host copies: the next replay may
                # overwrite the static buffers while they are formatted
                state = advance(state, G)
                obs.count("stream.ahead")
            for b in fresh:
                with obs.span("engine.rows"):
                    rows = self._rows_from(o_pt[b], o_E[b], o_act[b], o_n[b])
                tally(int(o_sid[b]), int(o_flag[b]), int(o_need[b]),
                      int(o_rneed[b]))
                yield int(o_sid[b]), rows, int(o_flag[b])
                emitted += 1

    def _fetch(self, state, keys):
        """The int32 and bool tensors `keys` of `state` as numpy arrays, in
        one device-to-host copy (one host read), after which the replays'
        stage clocks are read."""
        with obs.span("engine.read"):
            ts = [state[k] for k in keys]
            flat = torch.cat([t.reshape(-1).to(torch.int32) for t in ts])
            flat = flat.cpu().numpy()
            self._read_stages()
        out, at = [], 0
        for t in ts:
            x = flat[at: at + t.numel()].reshape(tuple(t.shape))
            out.append(x.astype(bool) if t.dtype == torch.bool else x)
            at += t.numel()
        return out

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
    def run(self, seqs, collect_traj=False, structures=False):
        """Fold `seqs` (at most B) to their fixed points.  Returns the
        final beams (one per sequence), the trajectory (the beam before
        every step) with collect_traj=True, and the last state.  On a
        card (graphs) the steps are replays of a graph of 4 steps, or of
        one step with collect_traj=True; the last state is then the
        engine's static buffers (the next run overwrites them).  A beam
        is [(dot_bracket, energy_kcal)] best-first, or with
        structures=True a list of Structure whose pair_list and
        node_list are filled (_structures).  Traced (obs): the read of
        `done` is the span engine.read."""
        read = self._structures if structures else self._beams
        state = self.init_state(seqs)
        traj = []
        # replaying graphs without a trajectory, the host reads `done`
        # once per G steps: a step on a finished batch leaves it as it was
        G = 4 if self.graphs and not collect_traj else 1
        steps = 0
        while steps < self.cfg.max_steps:
            with obs.span("engine.read"):
                finished = bool(state["done"].all())
                self._read_stages()
            if finished:
                break
            if collect_traj:
                traj.append(read(state, len(seqs)))
            g = min(G, self.cfg.max_steps - steps)
            state = (self._graphed(self._steps, state, g) if self.graphs
                     else self._steps(state, g))
            steps += g
        beams = read(state, len(seqs))
        self._read_stages()
        if collect_traj:
            return beams, traj, state
        return beams, state

    def _beams(self, state, nseq):
        pt, E, act, n = (state[k].cpu().numpy()
                         for k in ("pt", "energy", "active", "n"))
        return [self._rows_from(pt[b], E[b], act[b], n[b]) for b in range(nseq)]

    def _structures(self, state, nseq):
        """The beams as fold_cpu's Structure objects, one host read per
        call:

        - pair_list: the row's pairs as (i, j) tuples with i < j, sorted
          by i (fold_cpu appends them stem by stem; the pair set is what
          its consumers read, struct.merge_pair_list);
        - node_list: the open regions in the row's region order (rorder,
          fold_cpu's node_list order), each its unpaired member
          positions ascending as an int64 array;
        - energy and str_struct as in _beams."""
        with obs.span("engine.structures"):
            cfg, B = self.cfg, self.B
            K, N = cfg.K, cfg.N
            pt, n, rorder = state["pt"], state["n"], state["rorder"]
            loops = analyze_pt(self.dp,
                               state["codes"][:, None].expand(B, K, N), pt,
                               n[:, None].expand(B, K))
            rpos, _, _, mlen = _regions(cfg, pt, loops["enclose"], rorder, n)
            pt, E, act, n, ror, rpos, mlen = (
                x.cpu().numpy() for x in (pt, state["energy"],
                                          state["active"], n, rorder, rpos,
                                          mlen))
            out = []
            for b in range(nseq):
                beam = []
                for k in np.flatnonzero(act[b]):
                    row = pt[b, k, : n[b]]
                    ii = np.flatnonzero(row > np.arange(n[b]))
                    pairs = [(int(i), int(row[i])) for i in ii]
                    nodes = [rpos[b, k, r, : mlen[b, k, r]].astype(np.int64)
                             for r in np.flatnonzero(ror[b, k] > -2)]
                    beam.append(Structure(
                        nodes, pairs, float(np.float32(int(E[b, k]) / 100.0)),
                        dot_bracket(pairs, int(n[b]))))
                out.append(beam)
            return out


def fold_one_config(n, nb_mode=100, max_stack=1, max_branch=100, min_hp=3,
                    min_nrj=0.0, temp=37.0, gc_wei=3.0, au_wei=2.0,
                    gu_wei=1.0) -> EngineConfig:
    """The configuration fold_one folds a sequence of n nt at."""
    N = 1 << max(5, int(np.ceil(np.log2(max(8, n)))))
    return EngineConfig(N=N, K=max_stack, M=min(nb_mode, 2 * N - 1),
                        max_branch=max_branch,
                        CPLX=cplx_budget(512, max_stack),
                        min_hp=min_hp, min_nrj=min_nrj, temp=temp,
                        gc_wei=gc_wei, au_wei=au_wei, gu_wei=gu_wei,
                        V=min(4096, max(256, 2 * max_branch)),
                        S=max(4096, 16 * max_stack * 8),
                        R=region_slots(N))


# The engines that fold() and fold_one() keep between calls, so that a call
# at a configuration seen before replays the CUDA graphs its engine
# captured then: at most KEPT_ENGINES, least recently used out first.  Four
# hold the corpus's length mix (tools/measure.py --phases kept: 94% of calls
# hit at 4, 95% at 8, 63% at 1)
KEPT_ENGINES = 4
_kept = OrderedDict()       # (EngineConfig, torch.device) -> FoldEngine
_kept_lock = threading.Lock()


def release_engines():
    """Drop every engine that fold() and fold_one() keep.  Their state
    buffers, kernel tables, CUDA graphs and graph memory pools are freed
    only then, into PyTorch's caching allocator
    (torch.cuda.empty_cache() gives them back to the card).  An engine
    that a call is using at that moment is kept again when the call
    ends."""
    with _kept_lock:
        _kept.clear()


def _engine_key(cfg, device):
    """(cfg, device) with the device's index filled in: "cuda" and
    "cuda:<current device>" are one key."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return cfg, dev


@contextlib.contextmanager
def _kept_engine(cfg, device):
    """A B=1 engine for cfg on device: the kept one (obs counter
    fold.engine_hits), or one built now (fold.engine_misses); kept for
    later calls when the call ends.  A call takes the kept engine out of
    the store while it folds, so a call that wants it meanwhile builds
    one of its own.  An engine whose call raised is not kept."""
    key = _engine_key(cfg, device)
    with _kept_lock:
        eng = _kept.pop(key, None)
    obs.count("fold.engine_misses" if eng is None else "fold.engine_hits")
    if eng is None:
        eng = FoldEngine(cfg, B=1, device=key[1])
    yield eng
    with _kept_lock:
        _kept[key] = eng
        _kept.move_to_end(key)
        while len(_kept) > KEPT_ENGINES:
            _kept.popitem(last=False)


def _fold_one(sequence, nb_mode, max_stack, max_branch, min_hp, min_nrj,
              traj, temp, gc_wei, au_wei, gu_wei, device, structures=False):
    """fold_one's results and the fold's FLAG_* bitmask; with
    structures=True the Structure objects carry pair_list and node_list
    (FoldEngine._structures, what the root fold returns).  The engine is
    a kept one (_kept_engine)."""
    cfg = fold_one_config(len(sequence), nb_mode, max_stack, max_branch,
                          min_hp, min_nrj, temp, gc_wei, au_wei, gu_wei)
    if structures:
        mk = lambda beam: beam
    else:
        mk = lambda rows: [Structure([], [], e, db) for db, e in rows]
    with _kept_engine(cfg, device) as eng:
        if traj:
            beams, steps, state = eng.run([sequence], collect_traj=True,
                                          structures=structures)
            out = (mk(beams[0]), [mk(s[0]) for s in steps])
        else:
            beams, state = eng.run([sequence], structures=structures)
            out = mk(beams[0])
        # on a card the state is the engine's static buffers: read them
        # before the engine serves another call
        return out, int(eng.flags(state)[0])


def fold_one(sequence, nb_mode=100, max_stack=1, max_branch=100, min_hp=3,
             min_nrj=0.0, traj=False, temp=37.0, gc_wei=3.0, au_wei=2.0,
             gu_wei=1.0, *, device="cuda"):
    """Single-sequence API on the batched engine (reference fold()
    signature plus the device to run on).  A flagged fold is returned as
    the engine made it, and a configuration the engine refuses raises
    (engine_refusal): `fold` sends both to the CPU parity engine.  The
    engine is kept for later calls at the same configuration and device,
    as fold's is (release_engines)."""
    return _fold_one(sequence, nb_mode, max_stack, max_branch, min_hp,
                     min_nrj, traj, temp, gc_wei, au_wei, gu_wei, device)[0]


def flag_names(flag: int) -> str:
    return "+".join(c for b, c in FLAG_NAMES.items() if flag & b) or "none"


def fold_refusal(sequence, nb_mode, max_stack, cfg: EngineConfig) -> str | None:
    """Why the root fold sends a call to fold_cpu before building an
    engine, or None: the degenerate inputs (an empty sequence, no beam
    slot, no lag searched), whose answers fold_cpu gives and an engine
    cannot make, then what FoldEngine refuses (engine_refusal)."""
    if not sequence:
        return "the sequence is empty"
    if max_stack < 1:
        return f"max_stack={max_stack} leaves no beam slot"
    if nb_mode < 1:
        return f"nb_mode={nb_mode} searches no lag"
    return engine_refusal(cfg)


# fold() calls answered by fold_cpu: folds the engine flagged, and inputs
# the engine refuses or no engine is built for
REFOLDS = 0
obs.process_counter("fold.refolds", lambda: REFOLDS)


def fold(sequence, nb_mode=100, max_stack=1, max_branch=100, min_hp=3,
         min_nrj=0.0, traj=False, temp=37.0, gc_wei=3.0, au_wei=2.0,
         gu_wei=1.0, *, device="cuda"):
    """The package's `fold`: rafft_tpu.fold's signature and results, the
    final beam (and the trajectory with traj=True, the beam before every
    step, the last one included), plus the device.

    Folds on the batched engine at fold_one's configuration, except where
    the sequential CPU parity engine (fold_cpu, what rafft_tpu.fold runs)
    must answer instead:

    - inputs no engine is built for (fold_refusal): an empty sequence,
      max_stack < 1 and nb_mode < 1, then what the engine refuses
      (engine_refusal): max_stack > 255 (the pool's tie order), min_hp < 0
      (the wavefront tables' padding) and sequences over 4,096 nt (MAX_N,
      the largest bucket);
    - folds the engine flags as possibly inexact (a FLAG_* bit), as
      sweep() refolds them.

    Either is logged at INFO with its reason and counted in REFOLDS.  So
    the result equals rafft_tpu.fold's on every input.

    The engine is kept for later calls: a call at fold_one_config's
    configuration and the device of an earlier call reuses that call's
    engine and replays the CUDA graphs it captured, a call at a new one
    builds, warms up and captures an engine.  At most KEPT_ENGINES are
    kept, the least recently used dropped first; their memory comes back
    only after release_engines().  A kept engine serves one call at a
    time: a thread that wants it while it is in use folds on an engine
    of its own.

    Each Structure holds, as fold_cpu's do:

    - str_struct: the dot-bracket string;
    - energy: the Turner energy in kcal/mol, a float32 value;
    - pair_list: the base pairs as (i, j) tuples, i < j; from the engine
      sorted by i, from fold_cpu in the order its stems formed (the same
      set);
    - node_list: the regions still open for helix formation, in
      fold_cpu's order, each an int64 array of its unpaired positions
      ascending."""
    global REFOLDS
    with obs.span("fold.call"):
        args = (nb_mode, max_stack, max_branch, min_hp, min_nrj, traj, temp,
                gc_wei, au_wei, gu_wei)
        reason = fold_refusal(sequence, nb_mode, max_stack, fold_one_config(
            len(sequence), nb_mode, max_stack, max_branch, min_hp, min_nrj,
            temp, gc_wei, au_wei, gu_wei))
        if reason is None:
            out, flag = _fold_one(sequence, *args, device, structures=True)
            if not flag:
                return out
            reason = f"the engine flagged the fold ({flag_names(flag)})"
        from rafft_tpu_torch.engine import fold_cpu

        _LOG.info("fold: a %d-nt fold goes to fold_cpu: %s", len(sequence),
                  reason)
        REFOLDS += 1
        return fold_cpu.fold(sequence, *args)
