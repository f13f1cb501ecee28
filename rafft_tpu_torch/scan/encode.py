"""Sequence encodings for the correlation scan.

Semantics (parity target the reference's rafft/utils.py:70-84): the
forward strand is one-hot over channels (A, G, C, U); the backward
strand carries complement *pair weights* (gc_wei, au_wei, gu_wei) and is
reversed.  Instead of materialising per-region encoding slices, regions
here are plain position-index arrays and encodings are derived views:

    fwd[c, t] = [s[pos[t]] == channel c]
    bwd[c, t] = pairweight(channel c, s[pos[m-1-t]])

which is exactly the reference's slice/concat bookkeeping collapsed into
one gather.
"""

from __future__ import annotations

import numpy as np

# channel order of the reference one-hot: A, G, C, U
CHANNEL_CODES = np.array([1, 3, 2, 4], dtype=np.int32)  # codes: A=1,C=2,G=3,U=4


def weight_matrix(gc_wei=3.0, au_wei=2.0, gu_wei=1.0) -> np.ndarray:
    """W[a, b] = correlation weight of bases a,b (0=N,1=A,2=C,3=G,4=U)."""
    W = np.zeros((5, 5), dtype=np.float64)
    A, C, G, U = 1, 2, 3, 4
    W[A, U] = W[U, A] = au_wei
    W[G, C] = W[C, G] = gc_wei
    W[G, U] = W[U, G] = gu_wei
    return W


def forward_onehot(codes: np.ndarray) -> np.ndarray:
    """4 x m one-hot (channel order A,G,C,U) of base codes."""
    return (codes[None, :] == CHANNEL_CODES[:, None]).astype(np.float64)


def backward_weights(codes: np.ndarray, W: np.ndarray) -> np.ndarray:
    """4 x m reversed complement-weight encoding: column t carries the
    pair weights of base codes[m-1-t] against each channel base."""
    return W[CHANNEL_CODES[:, None], codes[None, ::-1]]
