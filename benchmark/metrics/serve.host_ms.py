"""Host ms per ``CohortServer.step`` call, mean over the measured window
(the harness's clock around each call, with the profiler off)."""


def read(t):
    host = t.values.get("host_step_s")
    return 1e3 * sum(host) / len(host) if host else None
