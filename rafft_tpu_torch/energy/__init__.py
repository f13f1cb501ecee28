"""Integer Turner-2004 nearest-neighbour energy model (dekacal/mol).

The port's copy of rafft_tpu/energy: the same tables and exports.

  params.py      - parameter container + temperature rescaling
  _turner2004.py - raw dG37/dH tables
  _calibrated.py - exact corrections recovered from the reference's
                   frozen (sequence, structure, energy) corpus
  eval_np.py     - exact integer CPU evaluator (the oracle)
  eval_torch.py  - batched PyTorch evaluator (same integer arithmetic)
  features.py    - structure -> loop-feature counts
"""

from rafft_tpu_torch.energy.eval_np import eval_structure, eval_structure_int
from rafft_tpu_torch.energy.params import EnergyParams, get_params

__all__ = ["EnergyParams", "get_params", "eval_structure", "eval_structure_int"]
