"""Host ms per served step in the online STFT and iSTFT: the self time of the
program's ``serve.stft`` and ``serve.istft`` spans (``dsp/stream_dsp.py``)
that lie inside the traced window, over its ``serve.cohort_step`` spans.
None where the program records no spans."""

NAMES = ("serve.stft", "serve.istft")


def self_ms_per_step(t, names) -> float | None:
    """Summed self time (a span's length less its child spans') of the
    program's spans named ``names`` inside the window, in ms per step."""
    try:
        from gtcrn_micro_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without spans
        return None
    spans = recorded().spans
    inside = [t.t0 <= s.start_ns and s.end_ns <= t.t1 for s in spans]
    steps = sum(ok and s.name == "serve.cohort_step" for s, ok in zip(spans, inside))
    if not steps:
        return None
    own = {i: s.end_ns - s.start_ns for i, s in enumerate(spans) if inside[i] and s.name in names}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return sum(own.values()) / steps / 1e6


def read(t):
    return self_ms_per_step(t, NAMES)
