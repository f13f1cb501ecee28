"""rafft_tpu_torch — the PyTorch port of rafft_tpu, for one NVIDIA card.

A second package beside the JAX reference `rafft_tpu`, with its public
API (mirroring the reference's two-function surface) and more:

    fold(sequence, ...)      -> list[Structure]  (optionally + trajectory)
    kinetics(fast_paths, ..) -> (trajectory, times, struct_list, str_equi_pop)
    mfe_fold(sequence, ...)  -> (dot_bracket, energy)

`fold` runs the batched fold engine `FoldEngine` (any pair weights,
beams up to K=255, the 128 to 4096 buckets; `fold_one` is its
one-sequence call; both keep their engines between calls until
`release_engines()`); a fold the engine flags, and an input it refuses
(fold_torch.engine_refusal), go to the sequential CPU parity engine
(engine/fold_cpu.py), so it gives what rafft_tpu.fold gives.  The engine's wavefront window scan is a
hand-written CUDA kernel for Hopper (csrc/wavefront.cu, built with nvcc
at first use).  The batched MFE DP `MfeEngine` / `mfe_batch`
(mfe/mfe_torch.py) runs on the card; `mfe_fold` is the native C++ Zuker
DP on the host (native/turner_eval.cpp, built with g++ at first use), as
in the JAX package.  Kinetics (kin/), the kinetics CLI (cli/kin_cli.py),
the analysis, feature and drawing helpers (analysis.py,
energy/features.py, viz/) are host numpy/scipy, as there.  The corpus
sweep (parallel/sweep.py, on one card, k cards or k processes) and the
fold CLI (cli/fold_cli.py) drive the engine.  Nothing here imports
rafft_tpu or JAX.  Entry points that compute on tensors run on
`device="cuda"` unless the caller names another; CPU tensors run the
kernel's plain version.
"""

from rafft_tpu_torch.engine.fold_torch import (EngineConfig, FoldEngine,
                                               fold, fold_one,
                                               release_engines)
from rafft_tpu_torch.kin.kinetics import kinetics
from rafft_tpu_torch.mfe import MfeEngine, mfe_batch, mfe_fold

__version__ = "0.1.0"

__all__ = ["fold", "kinetics", "mfe_fold", "__version__", "EngineConfig",
           "FoldEngine", "fold_one", "release_engines", "MfeEngine",
           "mfe_batch"]
