"""Device ms per served step of every operation that is not one of the
model backend's kernels: the online STFT and iSTFT and their glue."""


def read(t):
    steps = t.counters.get("steps", 0)
    if not steps or t.busy_s <= 0:
        return None
    return 1e3 * t.device_s(t.config["model_kernels"], exclude=True) / steps
