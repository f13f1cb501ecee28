"""rafft_tpu_torch — the batched fold engine of rafft_tpu in PyTorch.

A second package beside the JAX reference `rafft_tpu`: `FoldEngine`
(integral pair weights, the 128 to 1024 buckets) in plain tensor code,
with the wavefront window scan as a hand-written CUDA kernel for Hopper
(csrc/wavefront.cu, built with nvcc at first use); the corpus sweep
(parallel/sweep.py) and the fold CLI (cli/fold_cli.py) on top of
it.  Every entry point takes an explicit `device`; CPU tensors run the
kernel's plain version.
"""

from rafft_tpu_torch.engine.fold_torch import EngineConfig, FoldEngine, fold_one

__all__ = ["EngineConfig", "FoldEngine", "fold_one"]
