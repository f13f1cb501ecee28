"""The in-repo benchmark corpus: what the port's bench folds.

The corpus is the 2,296 sequences of the reference's benchmark: the
beams journal `benchmarks/artifacts/beams_100n50.jsonl.gz` (2,294 rows of
at most 780 nt, in its own order, each with its K=50 beam at -n 100
-ms 50 and its exactness flag), then the two 23S rRNAs of
`benchmarks/artifacts/longtail.ckpt.jsonl` (2,915 and 2,968 nt).  Both
files are read, never written.  A missing file raises: there is no
stand-in corpus.

`reference_order()` gives the same 2,296 sequences in the order of the
reference's benchmark CSV, the order the repo's tools read and write.
"""

from __future__ import annotations

import csv
import gzip
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
ARTIFACTS = os.path.join(ROOT, "benchmarks", "artifacts")
JOURNAL = os.path.join(ARTIFACTS, "beams_100n50.jsonl.gz")
LONGTAIL = os.path.join(ARTIFACTS, "longtail.ckpt.jsonl")
# written by merge_corpus in the reference benchmark's row order
SCORES = os.path.join(ARTIFACTS, "fft_100n_50ms_best_nrj_scores.csv")
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
    return short_rows(records)[:HEADLINE_ROWS]


def reference_order():
    """(seq, "", name) for every row of the reference's benchmark CSV, in
    its order: columns 0 and 7 of the committed
    fft_100n_50ms_best_nrj_scores.csv (2,296 rows), which merge_corpus
    writes in that order.  The truth column (the reference CSV's column
    1) is not in the repo and is left empty: only tools that do not
    score against the truth may read these records."""
    with open(SCORES) as fh:
        rows = list(csv.reader(fh))
    if rows[0][0] != "seq" or rows[0][7] != "name":
        raise ValueError(f"{SCORES}: unexpected header {rows[0]}")
    return [(r[0], "", r[7]) for r in rows[1:]]


def short_rows(records, max_nt=HEADLINE_MAX_NT):
    """The sequences of at most max_nt nt, in order, of records whose
    first field is the sequence: the rows the headline, debug_seq and
    perfcheck take."""
    return [r[0] for r in records if len(r[0]) <= max_nt]
