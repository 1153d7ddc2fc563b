"""The offline TF-Locoformer call's share of the card's float32 peak: 2 x
the multiply-adds of a call over the clips' own frames, not the bucket
padding (``benchmark/work_tflocoformer.call_macs`` of the traffic module's
``clip_frames``, at the configuration's widths) x calls / traced window
seconds / the peak of the configuration's precision."""

from benchmark import work, work_tflocoformer


def read(t):
    calls = t.counters.get("calls", 0)
    if not calls or t.busy_s <= 0 or "clip_frames" not in t.values:
        return None
    sizes = work_tflocoformer.sizes_of(t.config)
    flops = 2 * work_tflocoformer.call_macs(t.values["clip_frames"], **sizes) * calls
    return 100 * flops / t.window_s / work.PEAK_FLOPS[t.config["peak"]]
