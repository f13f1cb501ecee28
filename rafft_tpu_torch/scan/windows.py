"""Window-slide: find the maximal run of consecutive base pairs at a
given correlation lag.

Parity semantics (the reference's rafft/rafft.py:36-83): at lag `pos`
the strands align so local positions (i, pos-i) face each other (or
(pos-m+1+i, m-i-1) for pos >= m).  Only the first ceil(w/2) facing pairs
are scanned.  A chain value tot[i] = (tot[i-1]+tot[i])*tot[i] grows
through contiguous complementary runs (contiguity measured in *original*
coordinates through the region's position list, so stems never bridge
excised nucleotides).  The best (i) maximises tot[i] subject to a
minimum hairpin gap, preferring later i on ties; the returned run length
is the count of consecutive non-zero tot up to that i.

The numpy path is an exact float-for-float mirror.  The port's own copy
of rafft_tpu/scan/windows.py, for the CPU parity engine.
"""

from __future__ import annotations

import numpy as np


def window_slide_np(codes_region, pos_list, W, lag, min_hp):
    """Returns (run_len, i_local, j_local, score) in region-local indices."""
    m = codes_region.shape[0]
    if lag < m:
        w = lag + 1
    else:
        w = 2 * m - lag - 1
    half = w // 2 + (w % 2)

    tot = np.empty(half, dtype=np.float64)
    ip0 = 0 if lag < m else lag - m + 1
    jp0 = lag if lag < m else m - 1
    for i in range(half):
        if lag < m:
            ip, jp = i, lag - i
        else:
            ip, jp = lag - m + 1 + i, m - i - 1
        tot[i] = W[codes_region[ip], codes_region[jp]]

    max_nb, tmp_max, max_score, max_i, max_j = 0, 0, 0, 0, 0
    for i in range(half):
        if lag < m:
            ip, jp = i, lag - i
        else:
            ip, jp = lag - m + 1 + i, m - i - 1

        if i > 0 and pos_list[ip] - pos_list[ip - 1] == 1 and \
           pos_list[jp + 1] - pos_list[jp] == 1:
            tot[i] = (tot[i - 1] + tot[i]) * tot[i]

        if tot[i] == 0:
            tmp_max = 0
        else:
            tmp_max += 1

        if tot[i] >= max_score and pos_list[jp] - pos_list[ip] > min_hp:
            max_score = tot[i]
            max_nb = tmp_max
            max_i, max_j = ip, jp

    return max_nb, max_i, max_j, max_score
