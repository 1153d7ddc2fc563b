"""Share of the frames the offline calls compute that ran as replays of a
CUDA graph: 100 x ``infer.frames_graphed`` / ``infer.frames_computed``, the
program's counters in ``eval/infer.enhance_wavs``, which count only while the
profiler is on (in a run of the benchmark, the traced window's calls).  On a
card every batch adds to ``infer.frames_graphed``, 0 where it ran eager, so
a model run eager reads 0.  None where the program has no such counter (on
the CPU, or in a program without graphs)."""


def read(t):
    try:
        from gtcrn_micro_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without counters
        return None
    c = recorded().counters
    computed = c.get("infer.frames_computed", 0)
    if not computed or "infer.frames_graphed" not in c:
        return None
    return 100 * c["infer.frames_graphed"] / computed
