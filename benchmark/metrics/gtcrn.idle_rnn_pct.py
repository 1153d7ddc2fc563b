"""Share of the traced window in which nothing runs on the device while the
innermost open program span is one of GTCRN's recurrent spans
(``gtcrn.intra``, ``gtcrn.inter``, ``gtcrn.tra``): the host enqueuing the
GRUs' per-step launches, and their fc, LayerNorm and gate.  Computed as
``offline.idle_launch_pct`` computes its own (its ``idle_pct``, summed over
the three spans, which never nest in one another)."""

from pathlib import Path

from benchmark.run import load_module

NAMES = ("gtcrn.intra", "gtcrn.inter", "gtcrn.tra")


def read(t):
    split = load_module(Path(__file__).with_name("offline.idle_launch_pct.py"),
                        "bench_metric_offline.idle_launch_pct")
    parts = [split.idle_pct(t, name) for name in NAMES]
    if any(p is None for p in parts):
        return None
    return sum(parts)
