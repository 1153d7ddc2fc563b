"""The whole served step's share of the card's peak in the configuration's
precision: 2 x multiply-adds of a stream-frame x stream-frames of the traced
window / its seconds / the peak.  The DSP counts nothing."""

from benchmark import work


def read(t):
    frames = t.counters.get("stream_frames", 0)
    if not frames or t.busy_s <= 0:
        return None
    return 100 * 2 * work.frame_macs() * frames / t.window_s / work.PEAK_FLOPS[t.config["peak"]]
