"""The comparison that decides `correct`: the program's answers against
the plain reference (perfbench/reference), which folds the same
sequences again from scratch in worker processes that import nothing of
the program.

An answer is put in one canonical form on both sides:

- a beam of rows: [(dot-bracket, energy in integer dekacal/mol)] in
  beam order, and the fold's exactness flag bits (the reference's are 0);
- with a trajectory: the final beam and every step's beam, each
  structure as (dot-bracket, energy, sorted pair list, node list: the
  open regions in order, each its unpaired positions).
"""

from __future__ import annotations

import multiprocessing as mp
import os

import numpy as np


def dekacal(energy_kcal) -> int:
    """An energy read as float32 kcal/mol, back in integer dekacal/mol."""
    return int(round(float(energy_kcal) * 100))


def canon_rows(rows, flag=0):
    """(rows, flag) of a final beam of (dot-bracket, kcal/mol) rows."""
    return [(db, dekacal(e)) for db, e in rows], int(flag)


def canon_structures(beam):
    return [(s.str_struct, dekacal(s.energy),
             tuple(sorted((int(i), int(j)) for i, j in s.pair_list)),
             tuple(tuple(int(x) for x in node) for node in s.node_list))
            for s in beam]


def canon_trajectory(beam, steps):
    return canon_structures(beam), [canon_structures(s) for s in steps]


def reference_answer(job):
    """The reference's answer for (sequence, settings, precision, form),
    in canonical form `form` ("rows", "structures" or "trajectory"):
    what a worker process computes."""
    from perfbench.reference.fold import fold
    seq, settings, precision, form = job
    kw = {k: settings[k] for k in ("nb_mode", "max_stack", "max_branch",
                                   "min_hp", "min_nrj", "temp", "gc_wei",
                                   "au_wei", "gu_wei")}
    if form == "trajectory":
        return canon_trajectory(*fold(seq, traj=True, precision=precision,
                                      **kw))
    beam = fold(seq, precision=precision, **kw)
    if form == "structures":
        return canon_structures(beam)
    return canon_rows([(s.str_struct, s.energy) for s in beam])


def reference_answers(seqs, settings, form, precision="float32",
                      workers=None):
    """Canonical reference answers of `seqs`, in order, folded by a pool
    of spawned workers (longest first, so the pool ends together); every
    worker has ended when this returns."""
    workers = max(1, min(workers or os.cpu_count() or 1, len(seqs)))
    order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
    jobs = [(seqs[i], settings, precision, form) for i in order]
    ctx = mp.get_context("spawn")
    with ctx.Pool(workers) as pool:
        got = pool.map(reference_answer, jobs, chunksize=1)
        pool.close()
        pool.join()
    out = [None] * len(seqs)
    for i, ans in zip(order, got):
        out[i] = ans
    return out


def mismatches(answers, expected):
    """How many answers differ from their expected answer."""
    return int(sum(a != e for a, e in zip(answers, expected, strict=True)))


def first_mismatch(seqs, answers, expected):
    """A short account of the first differing answer, or None."""
    for seq, a, e in zip(seqs, answers, expected):
        if a != e:
            return (f"{len(seq)} nt {seq[:40]}...: program {str(a)[:300]} "
                    f"reference {str(e)[:300]}")
    return None


def lengths(seqs):
    return np.array([len(s) for s in seqs])
