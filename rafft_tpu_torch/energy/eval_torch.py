"""Batched PyTorch evaluator for the integer Turner-2004 model.

Counterpart of rafft_tpu/energy/eval_jax.py.  Every function takes
tensors with any leading batch dimensions (a structure is the last axis
of length N) and works on whatever device its inputs live on.  All
arithmetic is int32 dekacal, so results equal the JAX evaluator and the
CPU oracle exactly.

The JAX module packs its tables for the TPU (one-hot einsums, select
chains, a combined small-loop table); here every lookup is a plain
gather into the Turner tables.  The loop relations are computed per
position instead of over compacted openings: a position that does not
open a pair is masked at the end.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from rafft_tpu_torch.energy._turner2004 import PAIR_TYPE
from rafft_tpu_torch.energy.params import (INT_MISS, EnergyParams,
                                           dense_special, get_params)

# the tables the fold path reads (eval_jax.DeviceParams minus the
# TPU-only repackings small_loop / small2d / mm3 / *_items)
TABLES = ("pair_type", "stack", "hairpin", "bulge", "internal",
          "mmh", "mmi", "mm1n", "mm23", "mmm", "mmext", "d5", "d3",
          "int11", "int21", "int22", "tetra", "tri", "hexa")
SCALARS = ("terminal_au", "ml_closing", "ml_intern", "ml_base",
           "ninio_m", "ninio_max")


def param_arrays(p: EnergyParams, max_len: int) -> dict:
    """The numpy tables and scalars of DeviceParams, by attribute name."""
    L = max_len + 2
    return dict(
        pair_type=PAIR_TYPE, stack=p.stack,
        hairpin=p.hairpin_ext[:L], bulge=p.bulge_ext[:L],
        internal=p.internal_ext[:L],
        mmh=p.mismatch_h, mmi=p.mismatch_i, mm1n=p.mismatch_1n,
        mm23=p.mismatch_23, mmm=p.mismatch_m, mmext=p.mismatch_ext,
        d5=p.dangle5, d3=p.dangle3,
        int11=p.int11, int21=p.int21, int22=p.int22,
        tetra=dense_special(p.tetraloops, 6),
        tri=dense_special(p.triloops, 5),
        hexa=dense_special(p.hexaloops, 8),
        terminal_au=p.terminal_au, ml_closing=p.ml_closing,
        ml_intern=p.ml_intern, ml_base=p.ml_base, ninio_m=p.ninio_m,
        ninio_max=p.ninio_max)


class DeviceParams(nn.Module):
    """Energy tables as int32 buffers; the scalars as Python ints."""

    def __init__(self, arrays: dict, temp: float):
        super().__init__()
        self.temp = temp
        for k in TABLES:
            self.register_buffer(
                k, torch.as_tensor(np.array(arrays[k], np.int32)))
        for k in SCALARS:
            setattr(self, k, int(np.asarray(arrays[k])))


_DP_CACHE: dict = {}


def device_params(temp: float, max_len: int, device) -> DeviceParams:
    device = torch.device(device)
    key = (temp, max_len, device)
    if key not in _DP_CACHE:
        arrays = param_arrays(get_params(temp), max_len)
        _DP_CACHE[key] = DeviceParams(arrays, temp).to(device)
    return _DP_CACHE[key]


# ----------------------------------------------------------------------
# lookups
# ----------------------------------------------------------------------

def take(tab, idx):
    """tab[..., idx] along the last axis.  tab's leading dims must be a
    prefix of idx's; indices must be in range."""
    lead = tab.shape[:-1]
    return tab.gather(-1, idx.reshape(*lead, -1).long()).reshape(idx.shape)


def _g(table, *idx):
    """table[idx0, idx1, ...] with broadcasting index tensors."""
    lin = idx[0]
    for d, ix in zip(table.shape[1:], idx[1:]):
        lin = lin * d + ix
    return table.reshape(-1)[lin.long()]


def _ptype(dp, a, b):
    t = _g(dp.pair_type, a, b)
    return torch.where(t == 0, 7, t)


def _sget(codes, i, n1):
    """codes[..., i] with 0 (N) outside [0, n); n1 broadcasts against i."""
    N = codes.shape[-1]
    v = take(codes, i.clamp(0, N - 1))
    return torch.where((i >= 0) & (i < n1), v, 0)


def _kmer_keys(codes, k: int):
    """key[..., i] = base-5 encoding of codes[..., i:i+k] (0-padded)."""
    key = torch.zeros_like(codes)
    for t in range(k):
        sh = torch.nn.functional.pad(codes[..., t:], (0, t))
        key = key * 5 + sh
    return key


def _au(dp, t):
    return (t > 2).to(torch.int32) * dp.terminal_au


def _hairpin_v(dp, t, si1, sj1, size, k5, k6, k8):
    """Hairpin energy from pre-gathered values (eval_jax._hairpin_v)."""
    e = dp.hairpin[size.clamp(0, dp.hairpin.shape[0] - 1).long()]
    mism = _g(dp.mmh, t, si1, sj1)
    tri_e = dp.tri[k5.clamp(0, dp.tri.shape[0] - 1).long()]
    tet_e = dp.tetra[k6.clamp(0, dp.tetra.shape[0] - 1).long()]
    hex_e = dp.hexa[k8.clamp(0, dp.hexa.shape[0] - 1).long()]
    generic = e + mism
    tri_out = torch.where(tri_e != INT_MISS, tri_e, e + _au(dp, t))
    tet_out = torch.where(tet_e != INT_MISS, tet_e, generic)
    hex_out = torch.where(hex_e != INT_MISS, hex_e, generic)
    return torch.where(size == 3, tri_out,
                       torch.where(size == 4, tet_out,
                                   torch.where(size == 6, hex_out, generic)))


def _int_loop_v(dp, t1, t2, si1, sj1, sp1, sq1, n1, n2):
    """Two-loop energy from pre-gathered values (eval_jax._int_loop_v).

    t1 = type of closing pair (i, j); t2 = type of inner pair seen from
    inside; si1/sj1 = codes[i+1]/codes[j-1]; sp1/sq1 = codes[q-1] /
    codes[r+1]; n1/n2 = unpaired runs q-i-1 / j-r-1."""
    nl = torch.maximum(n1, n2)
    ns = torch.minimum(n1, n2)

    stack_e = _g(dp.stack, t1, t2)
    blg = dp.bulge[nl.clamp(0, dp.bulge.shape[0] - 1).long()]
    bulge_e = blg + torch.where(nl == 1, stack_e, _au(dp, t1) + _au(dp, t2))

    # int21 orientation: bulge-of-1 on the 5' side keys (t1,t2,si1,sq1,sj1),
    # otherwise the reversed frame (t2,t1,sq1,si1,sp1)
    fwd21 = n1 == 1
    v11 = _g(dp.int11, t1, t2, si1, sj1)
    v21 = _g(dp.int21, torch.where(fwd21, t1, t2), torch.where(fwd21, t2, t1),
             torch.where(fwd21, si1, sq1), torch.where(fwd21, sq1, si1),
             torch.where(fwd21, sj1, sp1))
    v22 = _g(dp.int22, t1, t2, si1, sp1, sq1, sj1)
    small = torch.where((ns == 1) & (nl == 1), v11,
                        torch.where((ns == 1) & (nl == 2), v21,
                                    torch.where((ns == 2) & (nl == 2), v22, 0)))

    ninio = torch.clamp((nl - ns) * dp.ninio_m, max=dp.ninio_max)
    internal = dp.internal
    top = internal.shape[0] - 1
    onexn = (internal[(nl + 1).clamp(0, top).long()] + ninio
             + _g(dp.mm1n, t1, si1, sj1) + _g(dp.mm1n, t2, sq1, sp1))
    l23 = (internal[5] + dp.ninio_m
           + _g(dp.mm23, t1, si1, sj1) + _g(dp.mm23, t2, sq1, sp1))
    generic = (internal[(nl + ns).clamp(0, top).long()] + ninio
               + _g(dp.mmi, t1, si1, sj1) + _g(dp.mmi, t2, sq1, sp1))

    ns1 = torch.where(nl <= 2, small, onexn)
    ns2 = torch.where(nl == 2, small, torch.where(nl == 3, l23, generic))
    inner = torch.where(ns == 1, ns1, torch.where(ns == 2, ns2, generic))
    return torch.where(nl == 0, stack_e, torch.where(ns == 0, bulge_e, inner))


def _ml_stem(dp, t, s5, s3):
    return _g(dp.mmm, t, s5, s3) + _au(dp, t) + dp.ml_intern


def _ext_stem_v(dp, t, s5, s3, has5, has3):
    """Exterior stem term (t = type of (i,j), s5/s3 = codes[i-1]/codes[j+1],
    has5/has3 = neighbour-exists masks)."""
    e = torch.where(
        has5 & has3, _g(dp.mmext, t, s5, s3),
        torch.where(has5, _g(dp.d5, t, s5),
                    torch.where(has3, _g(dp.d3, t, s3), 0)))
    return e + _au(dp, t)


# ----------------------------------------------------------------------
# index-taking loop energies (the MFE DP's view)
# ----------------------------------------------------------------------
# codes [..., N] and n [...] share leading dims L; every position tensor
# has L's rank plus its own trailing dims, with leading dims equal to L
# or 1 (expanded here), and the positions broadcast against each other.

def _lead(codes, x):
    lead = codes.shape[:-1]
    return x.expand(*lead, *x.shape[len(lead):])


def _n_as(n, x):
    return n.reshape(*n.shape, *(1,) * (x.dim() - n.dim()))


def _at(codes, n, i):
    """codes[..., i] with 0 outside [0, n), for a position tensor i."""
    i = _lead(codes, i)
    return _sget(codes, i, _n_as(n, i))


def _hairpin(dp, codes, n, i, j, key5, key6, key8):
    """Hairpin closed by (i, j) (eval_jax._hairpin); key* = _kmer_keys."""
    t = _ptype(dp, _at(codes, n, i), _at(codes, n, j))
    k5, k6, k8 = (take(k, _lead(codes, i)) for k in (key5, key6, key8))
    return _hairpin_v(dp, t, _at(codes, n, i + 1), _at(codes, n, j - 1),
                      j - i - 1, k5, k6, k8)


def _int_loop(dp, codes, n, i, j, q, r):
    """Two-loop closed by (i, j) with inner pair (q, r) (eval_jax._int_loop)."""
    t1 = _ptype(dp, _at(codes, n, i), _at(codes, n, j))
    t2 = _ptype(dp, _at(codes, n, r), _at(codes, n, q))
    return _int_loop_v(dp, t1, t2, _at(codes, n, i + 1), _at(codes, n, j - 1),
                       _at(codes, n, q - 1), _at(codes, n, r + 1),
                       q - i - 1, j - r - 1)


def _ext_stem(dp, codes, n, i, j):
    """Exterior stem (i, j) (eval_jax._ext_stem)."""
    t = _ptype(dp, _at(codes, n, i), _at(codes, n, j))
    return _ext_stem_v(dp, t, _at(codes, n, i - 1), _at(codes, n, j + 1),
                       i > 0, j < _n_as(n, j) - 1)


# ----------------------------------------------------------------------
# whole pair tables
# ----------------------------------------------------------------------

def _enclose(pt, is_open, n1):
    """Innermost enclosing opening of every position of nested pair
    tables [..., N]: the largest p < i with pt[p] > i, -1 = exterior.

    O(N log N) and O(N) memory per table instead of the [N, N] relation
    of eval_jax: with depth(i) = openings before i minus closings at or
    before i, the innermost enclosure of i is the last opening before i
    whose own depth is depth(i) - 1 (a later opening at that depth would
    lie inside it).  Openings are sorted by (depth, position); every
    other position sorts past them and never matches."""
    N = pt.shape[-1]
    i64 = torch.int64
    ii = torch.arange(N, dtype=i64, device=pt.device)
    is_close = (ii < n1) & (pt >= 0) & (pt < ii)
    opened = is_open.to(i64).cumsum(-1)
    depth = opened - is_open.to(i64) - is_close.to(i64).cumsum(-1)
    stride = N + 1
    keys = torch.where(is_open, depth * stride + ii, stride * stride)
    skeys = keys.sort(-1).values
    target = (depth - 1) * stride + ii
    hit = (torch.searchsorted(skeys, target) - 1).clamp(min=0)
    found = skeys.gather(-1, hit) % stride
    return torch.where(depth > 0, found, -1).to(torch.int32)


def _loops(dp, codes, pt, n):
    """Loop analysis of nested pair tables [..., N] (codes and pt share
    leading dims, n has them).  Per-position caches of every opening.

    Every intermediate is [..., N]: no [N, N] relation is built, so the
    memory is linear in the number of tables whatever their count."""
    N = codes.shape[-1]
    n1 = n[..., None]
    ii = torch.arange(N, dtype=torch.int32, device=codes.device)
    iib = ii.expand(codes.shape)
    is_open = (ii < n1) & (pt > ii)
    enclose = _enclose(pt, is_open, n1)

    ptc = pt.clamp(0, N - 1)
    t_stem = _ptype(dp, codes, take(codes, ptc))
    mls = _ml_stem(dp, t_stem, _sget(codes, iib - 1, n1),
                   _sget(codes, ptc + 1, n1))

    # children of opening p: the openings whose innermost enclosure is p,
    # reduced onto p by scatter (exterior children go to a spare slot N)
    child = is_open & (enclose >= 0)
    parent = torch.where(child, enclose, N).long()
    spare = (*codes.shape[:-1], N + 1)
    zeros = torch.zeros(spare, dtype=torch.int32, device=codes.device)
    branches = zeros.scatter_add(-1, parent, child.to(torch.int32))[..., :N]
    mlsum = zeros.scatter_add(-1, parent,
                              torch.where(child, mls, 0))[..., :N]
    first_child = torch.full_like(zeros, N).scatter_reduce(
        -1, parent, torch.where(child, iib, N), "amin",
        include_self=True)[..., :N]

    keys = [_kmer_keys(codes, k) for k in (5, 6, 8)]
    i_o, j_o = iib, ptc
    q = first_child.clamp(0, N - 1)
    r = take(pt, q).clamp(0, N - 1)

    def sg(i):
        return _sget(codes, i, n1)

    hp = _hairpin_v(dp, _ptype(dp, sg(i_o), sg(j_o)), sg(i_o + 1),
                    sg(j_o - 1), j_o - i_o - 1,
                    *(take(kk, i_o) for kk in keys))
    il = _int_loop_v(dp, _ptype(dp, sg(i_o), sg(j_o)), _ptype(dp, sg(r), sg(q)),
                     sg(i_o + 1), sg(j_o - 1), sg(q - 1), sg(r + 1),
                     q - i_o - 1, j_o - r - 1)
    tc = _ptype(dp, sg(j_o), sg(i_o))
    ml = dp.ml_closing + mlsum + _ml_stem(dp, tc, sg(j_o - 1), sg(i_o + 1))
    loop_e = torch.where(branches == 0, hp, torch.where(branches == 1, il, ml))
    ext = _ext_stem_v(dp, _ptype(dp, sg(i_o), sg(j_o)), sg(i_o - 1),
                      sg(j_o + 1), i_o > 0, j_o < n1 - 1)

    loop_e = torch.where(is_open, loop_e, 0)
    ext = torch.where(is_open, ext, 0)
    energy = (loop_e.sum(-1, dtype=torch.int32)
              + torch.where(enclose == -1, ext, 0).sum(-1, dtype=torch.int32))
    return dict(enclose=enclose, is_open=is_open,
                branches=torch.where(is_open, branches, 0),
                first_child=torch.where(is_open, first_child, N),
                mlsum=torch.where(is_open, mlsum, 0), loop_e=loop_e,
                mls=torch.where(is_open, mls, 0), exts=ext, energy=energy)


def eval_pt(dp: DeviceParams, codes, pt, n):
    """Integer energy of pair tables [..., N] -> [...] (eval_jax.eval_pt)."""
    return _loops(dp, codes, pt, n)["energy"]


def analyze_pt(dp: DeviceParams, codes, pt, n):
    """Loop analysis for the fold engine (eval_jax.analyze_pt), batched.

    Returns a dict of [..., N] tensors: enclose (innermost enclosing
    opening, -1 = exterior), is_open, and per-opening caches branches /
    first_child / mlsum / loop_e / mls / exts, plus energy [...]."""
    return _loops(dp, codes, pt, n)
