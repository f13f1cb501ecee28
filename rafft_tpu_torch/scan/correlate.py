"""Cross-correlation between the forward and backward strand encodings.

cor[k] = sum_{i+j=k} pairweight(s[pos[i]], s[pos[j]]), normalised by the
triangle overlap count (+pad), exactly as the reference
(the reference's rafft/utils.py:115-132).  Peaks at lag k mark
complementary palindromic registers: positions i and k-i can stack.

correlate_np runs scipy.signal.convolve per channel, including scipy's
auto direct/FFT method switch, so float noise (and therefore
tie-ordering of equal peaks) matches the reference bit-for-bit.

The numpy part of rafft_tpu/scan/correlate.py, kept as the port's own
copy for the CPU parity engine.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import convolve as _sp_convolve

from rafft_tpu_torch.scan.encode import forward_onehot, backward_weights


def correlate_np(codes_region: np.ndarray, W: np.ndarray, pad: float = 1.0):
    """Normalised correlation of one region (codes at its positions).

    Returns float64 array of length 2m-1 (lag = i+j in region-local
    coordinates)."""
    m = codes_region.shape[0]
    fwd = forward_onehot(codes_region)
    bwd = backward_weights(codes_region, W)
    # the reference convolves fwd with the re-flipped backward strand
    bwd_unflipped = bwd[:, ::-1]
    cor = np.zeros(2 * m - 1, dtype=np.float64)
    acc = []
    for c in range(4):
        acc.append(_sp_convolve(fwd[c], bwd_unflipped[c]))
    cor = np.sum(np.array(acc), axis=0)
    norm = [(el + pad) for el in list(range(m)) + list(range(m - 1))[::-1]]
    return cor / norm


def top_lags(cor: np.ndarray, nb_mode: int):
    """Reference lag ranking: stable ascending sort by value, then
    reversed — i.e. descending value, ties broken by descending lag
    (the reference's rafft/rafft.py:117-118,95)."""
    cor_l = [[i, c] for i, c in enumerate(cor)]
    cor_l.sort(key=lambda el: el[1])
    return [(int(i), c) for i, c in cor_l[::-1][:nb_mode]]
