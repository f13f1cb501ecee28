"""Self-contained PPV/sensitivity scorer.

Replaces the external RNAstructure `scorer` binary used by the reference
(the reference's benchmark_results/scoring.py:106-113).  Implements the
scorer's standard slip rule: a predicted pair (i, j) counts as correct if
the accepted structure contains (i, j), (i+-1, j) or (i, j+-1); symmetric
for sensitivity.

  PPV         = correct predicted pairs / predicted pairs
  sensitivity = found known pairs / known pairs

Both reported as percentages with 2 decimals (scorer log format).
"""

from __future__ import annotations

from rafft_tpu_torch.struct import paired_positions


def _slip_hits(pairs, target_set):
    hits = 0
    for i, j in pairs:
        if ((i, j) in target_set or (i + 1, j) in target_set
                or (i - 1, j) in target_set or (i, j + 1) in target_set
                or (i, j - 1) in target_set):
            hits += 1
    return hits


def score_pairs(pred_pairs, true_pairs):
    """Returns (ppv, sensitivity) in percent (0..100)."""
    pred = list(pred_pairs)
    true = list(true_pairs)
    tset = set(true)
    pset = set(pred)
    ppv = 100.0 * _slip_hits(pred, tset) / len(pred) if pred else 0.0
    sens = 100.0 * _slip_hits(true, pset) / len(true) if true else 0.0
    return round(ppv, 2), round(sens, 2)


def score_structures(pred_db: str, true_db: str):
    """Score two dot-bracket strings (pseudoknot brackets supported in
    the accepted structure, as in .ct ground truth)."""
    return score_pairs(paired_positions(pred_db), paired_positions(true_db))


def best_of(pred_dbs, true_db):
    """Best-PPV structure among a saved beam (reference's best-of-k
    selection).

    Reconstructs the frozen artifact
    (the reference's benchmark_results/fft_100n_50ms_scores.csv), produced
    by get_best_score.py:84-92 (``pred_pvv >= max_pvv`` keeps the *last*
    tested structure) over a historical bench output whose exact column
    order is unrecoverable (the ``../rafft.py`` it invoked,
    bench_fft.py:8, is not in the snapshot, and the shipped bin/rafft's
    5-token bench lines would be mis-strided by get_best_score's
    (struct, score) pairing).  Measured over every saved beam of a full
    corpus re-fold against the frozen rows, the closest mechanical rule —
    on struct-level agreement AND per-bin sensitivity — is:

        max PPV, then most predicted pairs, then last in beam order

    which matches 57.5% of frozen picks overall (vs 53.2% for
    forward-last / 44.7% for lowest-energy-of-max) and lands per-bin mean
    sensitivity within 2 points everywhere (<=80nt: 91.2 vs artifact
    93.2; see benchmarks/artifacts/parity_report.md).  An exhaustive
    grid over the reconstruction space — iteration order x stride-2
    subset x >=-tie direction x {rounded, unrounded} PPV x pair-count
    direction, 48 rules (benchmarks/bk_grid.py, results committed in
    benchmarks/artifacts/bk_grid_100n50.md) — confirms this rule is the
    argmin of joint per-bin |dsens|+|dppv| and that NO rule in the space
    exceeds 91.23 <=80-nt sensitivity on our beams: the residual ~2-pt
    gap is historical beam-content noise (different ViennaRNA/tie
    ordering in the authors' run), not a recoverable selection artifact.

    Structures with zero predicted pairs are skipped: the RNAstructure
    scorer reports PPV=nan for an empty prediction and ``nan >= max`` is
    always False (get_best_score.py:90-91).
    """
    true_pairs = paired_positions(true_db)
    best_key = None
    best = (0.0, 0.0, "." * len(true_db))
    for db in pred_dbs:
        pairs = paired_positions(db)
        if not pairs:
            continue
        ppv, sens = score_pairs(pairs, true_pairs)
        key = (ppv, len(pairs))
        if best_key is None or key >= best_key:
            best_key = key
            best = (ppv, sens, db)
    return best
