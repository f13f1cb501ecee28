"""Stem-detection scan for the CPU parity engine: encodings, numpy
cross-correlation and window slide (the numpy parts of rafft_tpu/scan)."""
