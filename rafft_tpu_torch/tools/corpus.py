"""The in-repo benchmark corpus: what the port's bench folds.

The corpus is the 2,296 sequences of the reference's benchmark: the
beams journal `benchmarks/artifacts/beams_100n50.jsonl.gz` (2,294 rows of
at most 780 nt, in its own order, each with its K=50 beam at -n 100
-ms 50 and its exactness flag), then the two 23S rRNAs of
`benchmarks/artifacts/longtail.ckpt.jsonl` (2,915 and 2,968 nt).  Both
files are read, never written.  A missing file raises: there is no
stand-in corpus.
"""

from __future__ import annotations

import gzip
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
ARTIFACTS = os.path.join(ROOT, "benchmarks", "artifacts")
JOURNAL = os.path.join(ARTIFACTS, "beams_100n50.jsonl.gz")
LONGTAIL = os.path.join(ARTIFACTS, "longtail.ckpt.jsonl")
# the headline population: the first HEADLINE_ROWS sequences of at most
# HEADLINE_MAX_NT nt, in corpus order
HEADLINE_MAX_NT = 120
HEADLINE_ROWS = 256


def journal():
    """The beams journal's rows {name, seq, flagged, beam}, in order."""
    with gzip.open(JOURNAL, "rt") as fh:
        return [json.loads(line) for line in fh]


def corpus():
    """(seq, journal row) for every journal row, in order, then (seq,
    None) for each sequence of the long tail, in its file's order."""
    with open(LONGTAIL) as fh:
        longtail = [json.loads(line)["seq"] for line in fh]
    return [(r["seq"], r) for r in journal()] + [(s, None) for s in longtail]


def by_bucket(records, buckets):
    """Bucket the records' sequences as bench.py does: each goes to the
    first bucket it fits.  Returns ({N: [seq, ...]} in corpus order,
    {N: count}, the count that fits no bucket)."""
    seqs_by_bucket, counts, n_longtail = {}, {}, 0
    for seq, _row in records:
        N = next((b for b in buckets if len(seq) <= b), None)
        if N is None:
            n_longtail += 1
            continue
        seqs_by_bucket.setdefault(N, []).append(seq)
        counts[N] = counts.get(N, 0) + 1
    return seqs_by_bucket, counts, n_longtail


def headline_rows(records):
    """The headline's sequences: the first 256 of at most 120 nt."""
    return [seq for seq, _row in records
            if len(seq) <= HEADLINE_MAX_NT][:HEADLINE_ROWS]
