"""The yardstick of the wavefront kernel's roofline share: the bytes and
operations one call needs, from the lengths of the regions it scans, and
the least time the card could take for them.

A frozen copy of the port's engine/wavefront.py:wavefront_work (with its
per-cell operation counts) and tools/measure.py:kernel_bound, kept under
the benchmark so that the count cannot move with the program: it reads
the same whatever implements the kernel.
"""

from __future__ import annotations

import numpy as np

# NVIDIA's H100 SXM data sheet, at its 700 W power limit: 3.35 TB/s of
# device memory; 67 TFLOP/s float32 counts a fused multiply-add as two,
# and the kernel may not fuse (--fmad=false), so 33.5e12 float32
# operations a second; int32 at half that rate
MEM_RATE = 3.35e12
F32_RATE = 33.5e12
INT_RATE = 16.75e12

# (int32, float32) operations: a cell inside its lag's half-window
# (the window-slide recurrence and the correlation add), a cell past it
# (the correlation add alone), a lag with no region cell (its closed form)
WINDOW_CELL_OPS = (60, 6)
COR_CELL_OPS = (5, 1)
PAD_LAG_OPS = (6, 0)


def wavefront_work(mlen, N: int) -> dict:
    """Bytes and operations one call on regions of lengths `mlen` (any
    shape, one entry a region) needs at bucket N.

    bytes: every input read once and every output written once.  A
    region of length m reads its length and the m real entries of its
    four rows, (4 m + 1) * 4 bytes, and writes seven tables of 2N
    entries, 7 * 2N * 4; the call reads the 25 weights and the 625 stack
    energies once.  Cells: a region of length m has m * m cells on lags
    0..2m-2; a lag of len cells keeps the window state over its first
    ceil(len / 2) of them."""
    m = np.asarray(mlen, np.int64).reshape(-1)

    def tri(k):                      # sum of ceil(l / 2) for l = 1..k
        k = np.maximum(k, 0)
        return ((k + 1) // 2) * ((k + 2) // 2)

    window = int((tri(m) + tri(m - 1)).sum())
    cells = int((m * m).sum())
    cor_only = cells - window
    pad_lags = int((2 * N - np.maximum(2 * m - 1, 0)).sum())
    counts = ((window, WINDOW_CELL_OPS), (cor_only, COR_CELL_OPS),
              (pad_lags, PAD_LAG_OPS))
    return dict(
        regions=int(m.size), cells=cells, window_cells=window,
        cor_cells=cor_only, pad_lags=pad_lags, positions=int(m.sum()),
        bytes=(int((4 * m + 1).sum()) + int(m.size) * 7 * 2 * N + 25 + 625) * 4,
        int_ops=sum(n * ops[0] for n, ops in counts),
        f32_ops=sum(n * ops[1] for n, ops in counts))


def least_seconds(work) -> float:
    """The least time the card could take for a wavefront_work() count:
    the larger of its bytes over the memory rate and its operations over
    the operation rates."""
    return max(work["bytes"] / MEM_RATE,
               work["f32_ops"] / F32_RATE + work["int_ops"] / INT_RATE)
