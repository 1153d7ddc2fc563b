"""TF-Locoformer's attention's share of its roofline: the FLOPs of its two
matmuls (``benchmark/work_tflocoformer.attn_flops``) over the query-key
frame pairs along time of the traced calls (the program's counter
``infer.frame_pairs``, rows x bucket frames squared a batch, padding
included, as the kernel computes it) and their frames along frequency
(``infer.frames_computed``, rows x bucket frames), over the attention
kernels' device time (``tflocoformer.attn_kernel_busy_pct``'s kernels) and
the peak of the configuration's precision.  None where the program has no
such counters or no such kernel ran."""

from pathlib import Path

from benchmark import work, work_tflocoformer
from benchmark.run import load_module


def read(t):
    try:
        from gtcrn_micro_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without counters
        return None
    counters = recorded().counters
    pairs, frames = counters.get("infer.frame_pairs", 0), counters.get("infer.frames_computed", 0)
    kernels = load_module(Path(__file__).with_name("tflocoformer.attn_kernel_busy_pct.py"),
                          "bench_metric_tflocoformer.attn_kernel_busy_pct")
    seconds = kernels.device_s(t)
    if not pairs or not frames or seconds <= 0:
        return None
    flops = work_tflocoformer.attn_flops(pairs, frames, **work_tflocoformer.sizes_of(t.config))
    return 100 * flops / seconds / work.PEAK_FLOPS[t.config["peak"]]
