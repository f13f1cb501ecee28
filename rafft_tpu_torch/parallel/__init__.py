"""Corpus sweeps on one card: length buckets, per-bucket engine
configurations and the CPU refold of flagged folds (parallel/sweep.py)."""
