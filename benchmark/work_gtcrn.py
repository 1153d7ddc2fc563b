"""The work of one GTCRN frame (Xiaobin-Rong/gtcrn, ``gtcrn.py``), counted
from the model's shapes alone, as ``benchmark/work.py`` counts GTCRN-Micro's.

``frame_macs()`` is the multiply-adds a frame needs: the ERB merge and
split count the nonzeros of their filters, neither the padding of the
frequency convs nor the zeros stuffed into the transposed convs count, and
the magnitude, the TRA energies and the complex mask count as work.py
counts them.  Each GRU step counts the products of its input and its
hidden state, ``3 H (I + H)`` a direction, and not its gates' elementwise
work.  ``frame_macs(dense=True)`` counts instead what the port's
``utils/complexity`` counts on the calls of the offline forward: every tap
of every contraction, padding and stuffed zeros included, the full ERB
matrices, and no elementwise work; a test holds the two to each other.
"""

from __future__ import annotations

import numpy as np

C, HALF, F_DOWN, HIDDEN = 16, 8, 33, 16
N_GTCONV, N_DPGRNN = 6, 2


def _gru(i: int, h: int) -> int:
    return 3 * h * (i + h)


def frame_work(bm_w: np.ndarray, bs_w: np.ndarray, dense: bool = False) -> int:
    """Multiply-adds of one frame; ``bm_w``, ``bs_w`` are the ERB merge and
    split filters."""
    def taps_stride2(fin, fout):  # k in 0..4 with 0 <= 2 fo + k - 2 < fin
        if dense:
            return 5 * fout
        return sum(1 for fo in range(fout) for k in range(5) if 0 <= 2 * fo + k - 2 < fin)

    def taps_up2(fin):  # zero-stuffed input of length 2 fin - 1
        if dense:
            return 5 * (2 * fin - 1)
        return sum(1 for fo in range(2 * fin - 1) for k in range(5)
                   if 0 <= fo + k - 2 <= 2 * fin - 2 and (fo + k - 2) % 2 == 0)

    def nnz(w):
        return w.size if dense else int(np.count_nonzero(w))

    f3 = 3 * F_DOWN if dense else sum(1 for f in range(F_DOWN) for k in range(3)
                                      if 0 <= f + k - 1 < F_DOWN)
    gtconv = (F_DOWN * 3 * HALF * C             # pw1 over the SFE'd half
              + 3 * f3 * C                      # depthwise 3x3, 3 time taps
              + F_DOWN * C * HALF               # pw2
              + _gru(HALF, 2 * HALF)            # TRA GRU, one step
              + 2 * HALF * HALF)                # TRA fc
    dpgrnn = (F_DOWN * 2 * 2 * _gru(HALF, HIDDEN // 4)  # intra: 2 groups x 2 directions
              + F_DOWN * HIDDEN * HIDDEN                # intra fc
              + F_DOWN * 2 * _gru(HALF, HIDDEN // 2)    # inter: 2 groups, one step
              + F_DOWN * HIDDEN * HIDDEN)               # inter fc
    macs = (3 * nnz(bm_w)                          # ERB merge of mag, re, im
            + taps_stride2(129, 65) * C * 9         # en0 over the SFE'd features
            + taps_stride2(65, 33) * C * C // 2     # en1, groups 2
            + N_GTCONV * gtconv
            + N_DPGRNN * dpgrnn
            + taps_up2(33) * C * C // 2             # de3, groups 2
            + taps_up2(65) * 2 * C                  # de4
            + 2 * nnz(bs_w))                        # ERB split of the mask
    if not dense:
        macs += 2 * 257 + N_GTCONV * HALF * F_DOWN + 4 * 257  # magnitude, energies, mask
    return macs


def frame_macs(dense: bool = False) -> int:
    """:func:`frame_work` at the published widths."""
    from benchmark.reference.gtcrn import erb_filters

    f = erb_filters()
    return frame_work(f.T, f, dense)
