"""Share of the traced window in which nothing runs on the device while the
innermost open program span is ``infer.read``: the wav reads and resampling
(``eval/infer.enhance_wavs``; the split is ``offline.idle_launch_pct``'s)."""

from pathlib import Path

from benchmark.run import load_module


def read(t):
    split = load_module(Path(__file__).with_name("offline.idle_launch_pct.py"),
                        "bench_metric_offline.idle_launch_pct")
    return split.idle_pct(t, "infer.read")
