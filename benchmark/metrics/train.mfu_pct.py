"""The whole training step's share of the card's float32 peak (TF32 is off):
3 x 2 x multiply-adds of a frame x frames per step x steps / traced window
seconds / the peak of the configuration's precision."""

from benchmark import work


def read(t):
    steps = t.counters.get("steps", 0)
    if not steps or t.busy_s <= 0:
        return None
    flops = 3 * 2 * work.frame_macs() * t.counters["frames_per_step"] * steps
    return 100 * flops / t.window_s / work.PEAK_FLOPS[t.config["peak"]]
