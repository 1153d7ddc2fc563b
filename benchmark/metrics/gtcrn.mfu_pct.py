"""The offline GTCRN call's share of the card's float32 peak: 2 x the
multiply-adds of a frame (``benchmark/work_gtcrn.frame_macs``) x the clips'
own frames (not the bucket padding) x calls / traced window seconds / the
peak of the configuration's precision."""

from benchmark import work, work_gtcrn


def read(t):
    calls = t.counters.get("calls", 0)
    if not calls or t.busy_s <= 0:
        return None
    flops = 2 * work_gtcrn.frame_macs() * t.counters["frames_per_call"] * calls
    return 100 * flops / t.window_s / work.PEAK_FLOPS[t.config["peak"]]
