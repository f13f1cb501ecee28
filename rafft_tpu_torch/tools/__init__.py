"""Measurement tools for the PyTorch port (run on a CUDA card)."""
