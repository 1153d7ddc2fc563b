"""How late the load generator dispatched a step against its phase slot:
the 99th percentile over every step of the window, in ms."""

import math


def read(t):
    late = sorted(t.values.get("dispatch_late_s", []))
    if not late:
        return None
    return 1e3 * late[min(len(late) - 1, math.ceil(0.99 * len(late)) - 1)]
