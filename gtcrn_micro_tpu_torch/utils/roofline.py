"""The least time an H100 could take for the fused per-frame forward (the
work of kernels B1 and B2), and the card's peak rates it is held to.

The bound of a step is the larger of two times: the bytes it must move
(the spectra in and out, the ring taps read and the new frames written, the
kernel weights once) over the memory rate, and the multiply-adds it must do
over the float32 rate (the kernels compute in float32 whatever the storage
dtype).  ``chip_smoke.py`` and ``scripts/roofline.py`` both read it here.
"""

from __future__ import annotations

import math

# NVIDIA's H100 SXM data sheet, dense rates, at the 700 W power limit
H100_F32_FLOPS = 67e12  # FP32 outside the tensor cores
H100_HBM_BYTES = 3.35e12
H100_INT8_OPS = 1979e12  # dense int8 tensor-core rate


def work_per_stream(W: dict) -> tuple[int, int, int]:
    """Per stream and frame: the multiply-adds the fused forward needs, and
    the ring values it reads and writes.  The fixed ERB merge and split count
    by the nonzeros of their matrices in the unpacked weights ``W``
    (``ops.fused_step.unpack``); the padding of the frequency convs and the
    zeros stuffed into the transposed convs count nothing."""
    from gtcrn_micro_tpu_torch.ops.fused_step import RING_DEFS

    def taps_stride2(fin, fout):  # k in 0..4 with 0 <= 2 fo + k - 2 < fin
        return sum(1 for fo in range(fout) for k in range(5) if 0 <= 2 * fo + k - 2 < fin)

    def taps_up2(fin):  # zero-stuffed input of length 2 fin - 1
        return sum(1 for fo in range(2 * fin - 1) for k in range(5)
                   if 0 <= fo + k - 2 <= 2 * fin - 2 and (fo + k - 2) % 2 == 0)

    f3 = sum(1 for f in range(33) for kf in range(3) if 0 <= f + kf - 1 < 33)  # 97
    gt_common = 33 * 16 * 8 * 2 + 8 * 33 + 8 * 3 + 8 * 8  # pw1, pw2, energy, TRA
    nnz = lambda w: int((w != 0).sum())  # noqa: E731
    macs = (2 * 257                           # mag: re^2 + im^2
            + 3 * nnz(W["bm_w"])              # ERB merge (mag, re, im)
            + 3 * (3 * 129 - 2)               # SFE: depthwise 3-tap over 3 channels
            + taps_stride2(129, 65) * 16 * 3  # en0
            + taps_stride2(65, 33) * 16 * 16  # en1
            + 3 * (gt_common + 3 * f3 * 16)   # encoder GTConv, depthwise 3x3
            + 8 * (2 * 33 * 16 * 16 + 3 * 16 * 33)  # TCNs
            + 3 * (gt_common + 3 * f3 * 16 * 16)    # decoder GTConv, full 3x3
            + taps_up2(33) * 16 * 16          # de3
            + taps_up2(65) * 2 * 16           # de4
            + 2 * nnz(W["bs_w"])              # ERB split (real, imag)
            + 4 * 257)                        # complex mask
    frame = sum(math.prod(shape) for _n, _L, _d, shape in RING_DEFS)
    return macs, 2 * frame, frame


def bound_ms(nbytes: float, ops: float, peak_ops: float = H100_F32_FLOPS) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` over the
    memory rate and ``ops`` over ``peak_ops``."""
    t_bytes, t_ops = nbytes / H100_HBM_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def fused_step_bound(W: dict, batch: int, itemsize: int,
                     kernel_floats: int) -> tuple[float, str, float, float]:
    """(ms, bound by, FLOPs, bytes) of one fused step of ``batch`` streams
    whose spectra and rings are stored ``itemsize`` bytes a value, with
    ``kernel_floats`` float32 kernel weights (``KernelWeights.buf``)."""
    macs, ring_read, ring_written = work_per_stream(W)
    flops = 2 * macs * batch
    nbytes = itemsize * batch * (2 * 257 * 2 + ring_read + ring_written) + 4 * kernel_floats
    ms, by = bound_ms(nbytes, flops)
    return ms, by, flops, nbytes
