"""Share of the traced window in which no operation ran on the device."""


def read(t):
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100 * (1 - t.busy_s / t.window_s)
