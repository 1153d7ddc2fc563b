"""Device operations (kernels, copies, fills) per training step in the
traced window (torch.profiler)."""


def read(t):
    steps = t.counters.get("steps", 0)
    return len(t.device_ops) / steps if steps and t.device_ops else None
