"""Host ms per training step spent waiting for the next batch from the
loader, mean over the measured window (the harness's clock around each
``next``, with the profiler off)."""


def read(t):
    waits = t.values.get("loader_wait_s")
    return 1e3 * sum(waits) / len(waits) if waits else None
