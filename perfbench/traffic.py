"""Traffic: the benchmark's copy of the corpus and the one generator that
turns a cell's traffic file and a seed into the sequences it sends.

The corpus is RAFFT's 2,296-sequence benchmark set (sequence and name of
each row), copied once into data/corpus.csv; a run reads nothing else.
"""

from __future__ import annotations

import csv
import os

import numpy as np

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "corpus.csv")

# independent streams drawn from one seed
STREAM_DRAW, STREAM_CHECK = 0, 1


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of `stream` for `seed` (any whole number)."""
    return np.random.default_rng([abs(seed), int(seed < 0), stream])


def corpus():
    """[(sequence, name)] of the corpus, in its order."""
    with open(CORPUS, newline="") as fh:
        rows = list(csv.reader(fh))
    if rows[0] != ["seq", "name"]:
        raise ValueError(f"{CORPUS}: unexpected header {rows[0]}")
    return [(r[0], r[1]) for r in rows[1:]]


def band(lo: int, hi: int):
    """The corpus sequences of lo..hi nt, in corpus order."""
    return [s for s, _ in corpus() if lo <= len(s) <= hi]


def draw(seqs, count: int, strata: int, seed: int):
    """`count` sequences drawn from `seqs` with replacement, stratified by
    length: the rows sorted by length are cut into `strata` groups of
    equal size, and each cycle of `strata` draws takes one row of every
    group, in a seeded order.  So every seed sends the same mix of
    lengths in every cycle, and a new seed sends other rows in another
    order."""
    order = sorted(range(len(seqs)), key=lambda i: (len(seqs[i]), i))
    groups = np.array_split(np.asarray(order), strata)
    g = rng(seed, STREAM_DRAW)
    out = []
    while len(out) < count:
        cycle = [int(grp[g.integers(len(grp))]) for grp in groups]
        g.shuffle(cycle)
        out.extend(cycle)
    return [seqs[i] for i in out[:count]]


def check_sample(count_done: int, size, lengths, seed: int, always=()):
    """Indices of the answers a run compares: all of them where `size` is
    None, else `size` drawn without replacement from the seed, with the
    longest sequence answered (its first occurrence) and the first `size`
    indices of `always` (the answers counted failed) always in."""
    if size is None or size >= count_done:
        return list(range(count_done))
    pick = set(rng(seed, STREAM_CHECK).choice(count_done, size, replace=False)
               .tolist())
    pick.add(int(np.argmax(lengths[:count_done])))
    pick.update(list(always)[:size])
    return sorted(pick)
