"""Closed loop: K cohorts stepped back to back, round-robin, each cohort a
client with one step outstanding (its next step is enqueued once its
previous one has completed, so K - 1 steps stay queued ahead of the device
and the host never blocks on a full launch queue).

``stream_capacity`` = stream-frames enhanced in the window / window seconds
/ 62.5 frames a second: the real-time streams one card sustains.  The window
closes after the round in which ``--seconds`` ran out, at the device's
completion of that round.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import Outcome, memory_peak
from benchmark.serving import Done, Served
from benchmark.trace import Trace, traced

FRAMES_PER_S = 62.5


def _rounds(sv: Served, seconds: float, events: list) -> tuple[int, float]:
    """Step every cohort in turn until ``seconds`` have passed; returns the
    steps and the seconds to the device's completion of the last."""
    steps, t0 = 0, time.perf_counter()
    while True:
        for c in range(sv.K):
            with sv.span("bench.wait"):
                events[c].synchronize()
            sv.step(c)
            events[c].record()
        steps += sv.K
        if time.perf_counter() - t0 >= seconds:
            break
    sv.ctx.sync()
    return steps, time.perf_counter() - t0


def run(ctx) -> Outcome:
    sv = Served(ctx)
    on_card = ctx.device.type == "cuda"
    events = [torch.cuda.Event() if on_card else Done() for _ in range(sv.K)]
    sv.warm(ctx.cell["warm_rounds"])
    _rounds(sv, 0.0, events)  # the loop's own calls, once, off the clock
    sv.rec_steps = [[] for _ in range(sv.K)]
    setup_s = ctx.setup_s()

    sv.host_s = []
    steps, window_s = _rounds(sv, ctx.seconds, events)
    host_s = sv.host_s
    capacity = steps * sv.B / window_s / FRAMES_PER_S
    ctx.log(f"{steps} steps of {sv.B} streams in {window_s:.4f} s on {sv.backend}")

    trace = None
    if ctx.trace:
        trace = Trace(ctx.config, ctx.cell)
        sv.trace_mode()
        with traced(trace, ("serve.step", "bench.wait")):
            n, _ = _rounds(sv, ctx.cell["trace_seconds"], events)
        trace.counters.update(steps=n, stream_frames=n * sv.B, batch=sv.B)
        trace.values["host_step_s"] = host_s
    peak = memory_peak(ctx.device)
    sv.free_program()
    checks, failed, readings = sv.checks(ctx.cell["limits"]["rel_err_max"], ctx.control)
    return Outcome({"stream_capacity": capacity}, setup_s, steps, failed, checks, peak, trace,
                   {"backend": sv.backend, "readings": readings})
