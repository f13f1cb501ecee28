"""Minimum-free-energy (Zuker) folding under the port's Turner model.

Counterpart of rafft_tpu/mfe/__init__.py: the MFE structure and energy,
the role of the reference's ViennaRNA `RNA.fold` baseline.  Two backends
share the calibrated parameter tables:

* `mfe_fold` - the native C++ Zuker DP (native/turner_eval.cpp, built
  with g++ at first use), exact integer dekacal arithmetic, on the host
  as in the JAX package;
* `rafft_tpu_torch.mfe.mfe_torch.MfeEngine` / `mfe_batch` - the batched
  anti-diagonal DP on the card (`device="cuda"` unless the caller names
  another), held bit-equal to the native DP.
"""

from __future__ import annotations

from rafft_tpu_torch.energy.params import encode_sequence
from rafft_tpu_torch.mfe.mfe_torch import MfeEngine, mfe_batch
from rafft_tpu_torch.native import turner_mfe
from rafft_tpu_torch.struct import dot_bracket

__all__ = ["mfe_fold", "mfe_fold_pt", "MfeEngine", "mfe_batch"]


def mfe_fold_pt(seq: str, temperature: float = 37.0):
    """(pair_table, energy_int_dekacal) of the MFE structure."""
    return turner_mfe(encode_sequence(seq), temperature)


def mfe_fold(seq: str, temperature: float = 37.0):
    """(dot_bracket, energy_kcal_per_mol) - the `RNA.fold` surface."""
    pt, e = mfe_fold_pt(seq, temperature)
    pairs = [(i, int(j)) for i, j in enumerate(pt) if j > i]
    return dot_bracket(pairs, len(pt)), e / 100.0

