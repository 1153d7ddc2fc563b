"""Host ms per served step in ``CohortServer.step`` outside the DSP and the
model: the self time of the program's ``serve.cohort_step`` spans inside the
traced window (the cast, the shards' scatter and gather, the bookkeeping)."""

from pathlib import Path

from benchmark.run import load_module


def read(t):
    dsp = load_module(Path(__file__).with_name("serve.host_dsp_ms.py"),
                      "bench_metric_serve.host_dsp_ms")
    return dsp.self_ms_per_step(t, ("serve.cohort_step",))
