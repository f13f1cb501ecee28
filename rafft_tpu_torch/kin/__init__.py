"""Kinetics: master-equation folding dynamics over the fast-folding graph.

  kinetics.py - parity engine (longdouble transition matrix, LAPACK eig,
                or the scaling-and-squaring expm propagator), host
                numpy/scipy as in the JAX package
  plot.py     - population-trajectory figure (matplotlib, loaded when a
                figure is drawn)
"""

from rafft_tpu_torch.kin.kinetics import get_transition_mat, kinetics

__all__ = ["kinetics", "get_transition_mat"]
