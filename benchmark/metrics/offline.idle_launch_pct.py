"""Share of the traced window in which nothing runs on the device while the
innermost open program span is ``infer.forward``: the host enqueuing the
STFT, the model and the iSTFT (``eval/infer.enhance_wavs``).  Each idle
interval is split over the spans open during it, by time.  None where the
program records no spans."""

import bisect
import itertools


def idle_pct(t, name: str) -> float | None:
    """Percent of the window that is idle on the device and inside the self
    time (not covered by a child span) of a program span called ``name``."""
    try:
        from gtcrn_micro_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without spans
        return None
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    spans = recorded().spans
    inside = [t.t0 <= s.start_ns and s.end_ns <= t.t1 for s in spans]
    if not any(ok and s.name == "infer.call" for s, ok in zip(spans, inside)):
        return None
    kids: dict = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    busy = t._intervals()  # merged, sorted, clipped to the window
    starts = [a for a, _ in busy]
    cum = [0, *itertools.accumulate(b - a for a, b in busy)]

    def busy_to(x):  # device-busy ns before x
        k = bisect.bisect_right(starts, x)
        return cum[k] - (max(0, busy[k - 1][1] - x) if k else 0)

    idle = 0
    for i, s in enumerate(spans):
        if not inside[i] or s.name != name:
            continue
        at = s.start_ns
        for a, b in sorted(kids.get(i, ())) + [(s.end_ns, s.end_ns)]:
            if a > at:
                idle += (a - at) - (busy_to(a) - busy_to(at))
            at = max(at, b)
    return 100 * idle / (t.t1 - t.t0)


def read(t):
    return idle_pct(t, "infer.forward")
