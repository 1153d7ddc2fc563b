"""Share of the frames the offline calls compute that are bucket padding:
100 x (``infer.frames_computed`` - ``infer.frames``) / ``infer.frames_computed``,
the program's counters in ``eval/infer.enhance_wavs``, which count only while
the profiler is on (in a run of the benchmark, the traced window's calls).
None where the program has no such counters."""


def read(t):
    try:
        from gtcrn_micro_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without counters
        return None
    c = recorded().counters
    computed = c.get("infer.frames_computed", 0)
    if not computed:
        return None
    return 100 * (computed - c.get("infer.frames", 0)) / computed
