"""The offline call's share of the card's float32 peak: 2 x multiply-adds of
a frame x the clips' own frames (not the bucket padding) x calls / traced
window seconds / the peak of the configuration's precision."""

from benchmark import work


def read(t):
    calls = t.counters.get("calls", 0)
    if not calls or t.busy_s <= 0:
        return None
    flops = 2 * work.frame_macs() * t.counters["frames_per_call"] * calls
    return 100 * flops / t.window_s / work.PEAK_FLOPS[t.config["peak"]]
