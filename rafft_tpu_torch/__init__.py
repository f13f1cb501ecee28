"""rafft_tpu_torch — the batched fold engine of rafft_tpu in PyTorch.

A second package beside the JAX reference `rafft_tpu`: `FoldEngine`
(integral pair weights, the 128 to 1024 buckets) in plain tensor code,
with the wavefront window scan as a hand-written CUDA kernel for Hopper
(csrc/wavefront.cu, built with nvcc at first use); the corpus sweep
(parallel/sweep.py) and the fold CLI (cli/fold_cli.py) on top of
it, and the package's own copies of the energy tables, the sequential
CPU parity engine (engine/fold_cpu.py) and its native evaluator
(native/turner_eval.cpp, built with g++ at first use): nothing here
imports rafft_tpu or JAX.  Entry points run on `device="cuda"` unless
the caller names another; CPU tensors run the kernel's plain version.
"""

from rafft_tpu_torch.engine.fold_torch import EngineConfig, FoldEngine, fold_one

__all__ = ["EngineConfig", "FoldEngine", "fold_one"]
