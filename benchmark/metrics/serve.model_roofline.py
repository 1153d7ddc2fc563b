"""The model backend's share of its roofline: the served step's bound at the
cell's batch (``work.served_step_bound_s``) over the device time per step of
the kernels named in the configuration's ``model_kernels``."""

from benchmark import work


def read(t):
    dev_s, steps = t.device_s(t.config["model_kernels"]), t.counters.get("steps", 0)
    if dev_s <= 0 or not steps:
        return None
    return 100 * work.served_step_bound_s(t.config, t.counters["batch"]) / (dev_s / steps)
