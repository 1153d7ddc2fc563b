"""Share of the traced window's device-busy time that falls inside the host
windows of GTCRN's recurrent spans (``gtcrn.intra``, ``gtcrn.inter``,
``gtcrn.tra``: ``nn/blocks.py``), joined to the device trace by time as the
``offline.idle_*`` readers join theirs.  None where the program records no
such spans.

The join counts a device interval by when it ran, not by which span
enqueued it.  Where the device runs behind the host, the work a span
enqueues spills past the span's end and the work enqueued before it runs
inside it: at each span boundary the error is at most the device time
queued at that moment.  In this cell the host is the bound (the device is
idle most of the window), so the queue at a boundary holds a few kernels of
microseconds each; a window whose device is busy most of the time would
need the span's own device operations (correlation ids) instead."""

NAMES = ("gtcrn.intra", "gtcrn.inter", "gtcrn.tra")


def read(t):
    try:
        from gtcrn_micro_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without spans
        return None
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    spans = sorted((s.start_ns, s.end_ns) for s in recorded().spans
                   if s.name in NAMES and t.t0 <= s.start_ns and s.end_ns <= t.t1)
    if not spans:
        return None
    merged: list = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    inside, i = 0, 0
    for a, b in t._intervals():  # merged, sorted, clipped to the window
        while i < len(merged) and merged[i][1] <= a:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < b:
            inside += min(b, merged[j][1]) - max(a, merged[j][0])
            j += 1
    return 100 * inside / (t.busy_s * 1e9)
