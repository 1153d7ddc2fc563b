"""Median device ms per cohort step of the window, between the CUDA events
recorded before and after each step."""

import statistics


def read(t):
    ms = t.values.get("step_device_ms", [])
    return statistics.median(ms) if ms else None
