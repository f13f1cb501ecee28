"""Cross-correlation between the forward and backward strand encodings.

cor[k] = sum_{i+j=k} pairweight(s[pos[i]], s[pos[j]]), normalised by the
triangle overlap count (+pad), exactly as the reference
(the reference's rafft/utils.py:115-132).  Peaks at lag k mark
complementary palindromic registers: positions i and k-i can stack.

correlate_np runs scipy.signal.convolve per channel, including scipy's
auto direct/FFT method switch, so float noise (and therefore
tie-ordering of equal peaks) matches the reference bit-for-bit.

The numpy part of rafft_tpu/scan/correlate.py, kept as the port's own
copy for the CPU parity engine, and correlate_fft: the batched FFT
correlation of the fold engine (fold_jax._correlate's transform) on
torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.signal import convolve as _sp_convolve

from rafft_tpu_torch.scan.encode import (CHANNEL_CODES, backward_weights,
                                         forward_onehot)


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


_CHANNELS = {}


def channel_codes(device):
    """CHANNEL_CODES as a tensor on `device`, copied from the host at the
    first call for that device and kept (a CUDA graph capture copies
    nothing from the host)."""
    device = torch.device(device)
    if device not in _CHANNELS:
        _CHANNELS[device] = torch.as_tensor(CHANNEL_CODES, device=device)
    return _CHANNELS[device]


def correlate_fft(W, rcodes):
    """Raw correlation sums of regions by FFT: [..., N] codes (0-padded
    past the region) -> float32 [..., 2N-1], entry k = sum over i + j = k
    of W[rcodes[i], rcodes[j]].

    Four channels (A, G, C, U): the one-hot of the codes against the
    channel's pair weights of the codes, multiplied in the frequency
    domain at length 2N (no wrap-around) and summed over channels after
    the inverse transform, as fold_jax._correlate does.  The sums carry
    float32 FFT noise; for integral weights the caller rounds them.

    W is the [5, 5] weight matrix, or that matrix as a float32 tensor on
    rcodes' device: given the tensor, and after a first call on that
    device, the function copies nothing from the host, as a CUDA graph
    capture requires."""
    N = rcodes.shape[-1]
    Wt = (W if isinstance(W, torch.Tensor)
          else torch.as_tensor(np.asarray(W, np.float32), device=rcodes.device))
    ch = channel_codes(rcodes.device)
    fwd = (rcodes[..., None, :] == ch[:, None]).to(torch.float32)
    wen = Wt[ch.long()][:, rcodes.long()].movedim(0, -2)      # [..., 4, N]
    F = 2 * N
    conv = torch.fft.irfft(torch.fft.rfft(fwd, n=F) * torch.fft.rfft(wen, n=F),
                           n=F)[..., : 2 * N - 1]
    return conv.sum(-2)
