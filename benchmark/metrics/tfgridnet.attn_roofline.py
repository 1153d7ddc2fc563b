"""The full-band attention's share of its roofline: the FLOPs of its two
matmuls over the query-key frame pairs the traced calls computed
(``benchmark/work_tfgridnet.attn_flops`` of the program's counter
``infer.frame_pairs``, rows x bucket frames squared a batch, padding
included, as the kernel computes it) over the attention kernels' device
time (``tfgridnet.attn_kernel_busy_pct``'s kernels) and the peak of the
configuration's precision.  None where the program has no such counter or
no such kernel ran."""

from pathlib import Path

from benchmark import work, work_tfgridnet
from benchmark.run import load_module


def read(t):
    try:
        from gtcrn_micro_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without counters
        return None
    pairs = recorded().counters.get("infer.frame_pairs", 0)
    kernels = load_module(Path(__file__).with_name("tfgridnet.attn_kernel_busy_pct.py"),
                          "bench_metric_tfgridnet.attn_kernel_busy_pct")
    seconds = kernels.device_s(t)
    if not pairs or seconds <= 0:
        return None
    flops = work_tfgridnet.attn_flops(pairs, **work_tfgridnet.sizes_of(t.config))
    return 100 * flops / seconds / work.PEAK_FLOPS[t.config["peak"]]
