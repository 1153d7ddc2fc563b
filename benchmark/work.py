"""The yardstick's arithmetic: the H100's published peaks and the work of one
GTCRN-Micro frame.

``work_per_stream`` counts the multiply-adds the per-frame forward needs and
the ring values it reads and writes, from the model's shapes alone: the ERB
merge and split count the nonzeros of their filters, and neither the
padding of the frequency convs nor the zeros stuffed into the transposed
convs count anything.  At the published widths it gives 550,815
multiply-adds a stream-frame.
"""

from __future__ import annotations

import math

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12

# (ring, length, tap stride, frame shape): the 20 causal caches of one stream
C, F_DOWN = 16, 33
RINGS = ([(f"enc{i}_dw", 2, 1, (C, F_DOWN)) for i in range(3)]
         + [(f"enc{i}_tra", 2, 1, (C // 2,)) for i in range(3)]
         + [(f"dec{i}_dw", 2, 1, (C, F_DOWN)) for i in range(3)]
         + [(f"dec{i}_tra", 2, 1, (C // 2,)) for i in range(3)]
         + [(f"tcn{s}{j}", 2 * 2 ** j, 2 ** j, (C, F_DOWN)) for s in range(2) for j in range(4)])


def work_per_stream(bm_w: np.ndarray, bs_w: np.ndarray) -> tuple[int, int, int]:
    """(multiply-adds, ring values read, ring values written) per stream and
    frame; ``bm_w``, ``bs_w`` are the ERB merge and split filters."""
    def taps_stride2(fin, fout):  # k in 0..4 with 0 <= 2 fo + k - 2 < fin
        return sum(1 for fo in range(fout) for k in range(5) if 0 <= 2 * fo + k - 2 < fin)

    def taps_up2(fin):  # zero-stuffed input of length 2 fin - 1
        return sum(1 for fo in range(2 * fin - 1) for k in range(5)
                   if 0 <= fo + k - 2 <= 2 * fin - 2 and (fo + k - 2) % 2 == 0)

    f3 = sum(1 for f in range(33) for kf in range(3) if 0 <= f + kf - 1 < 33)
    gt_common = 33 * 16 * 8 * 2 + 8 * 33 + 8 * 3 + 8 * 8  # pw1, pw2, energy, TRA
    macs = (2 * 257                                 # magnitude
            + 3 * int(np.count_nonzero(bm_w))       # ERB merge of mag, re, im
            + 3 * (3 * 129 - 2)                     # SFE
            + taps_stride2(129, 65) * 16 * 3        # en0
            + taps_stride2(65, 33) * 16 * 16        # en1
            + 3 * (gt_common + 3 * f3 * 16)         # encoder GTConv, depthwise 3x3
            + 8 * (2 * 33 * 16 * 16 + 3 * 16 * 33)  # TCNs
            + 3 * (gt_common + 3 * f3 * 16 * 16)    # decoder GTConv, full 3x3
            + taps_up2(33) * 16 * 16                # de3
            + taps_up2(65) * 2 * 16                 # de4
            + 2 * int(np.count_nonzero(bs_w))       # ERB split of the mask
            + 4 * 257)                              # complex mask
    frame = sum(math.prod(shape) for _n, _L, _d, shape in RINGS)
    return macs, 2 * frame, frame


def step_bound_s(batch: int, macs: int, ring_read: int, ring_written: int,
                 itemsize: int, weight_bytes: int, peak: str) -> float:
    """The least time of one served model step of ``batch`` streams: the
    larger of its bytes (spectra in and out, ring taps read, new frames
    written, the weights once) over the memory rate and its operations over
    the peak of the configuration's precision."""
    nbytes = itemsize * batch * (2 * 257 * 2 + ring_read + ring_written) + weight_bytes
    return max(nbytes / HBM_BYTES_S, 2 * macs * batch / PEAK_FLOPS[peak])


def frame_macs() -> int:
    """Multiply-adds of one stream-frame at the published widths."""
    from benchmark.reference.gtcrn import erb_filters

    f = erb_filters()
    return work_per_stream(f.T, f)[0]


def served_step_bound_s(config: dict, batch: int) -> float:
    """:func:`step_bound_s` of a served configuration's model step."""
    from benchmark.reference.gtcrn import erb_filters

    f = erb_filters()
    macs, read, written = work_per_stream(f.T, f)
    return step_bound_s(batch, macs, read, written, config["storage_bytes"],
                        4 * config["trainable_floats"], config["peak"])
