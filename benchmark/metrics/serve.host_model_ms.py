"""Host ms per served step in the model backend's step: the self time of the
program's ``serve.model`` spans inside the traced window (for B2, the ring
checks and the launch), over its ``serve.cohort_step`` spans."""

from pathlib import Path

from benchmark.run import load_module


def read(t):
    dsp = load_module(Path(__file__).with_name("serve.host_dsp_ms.py"),
                      "bench_metric_serve.host_dsp_ms")
    return dsp.self_ms_per_step(t, ("serve.model",))
