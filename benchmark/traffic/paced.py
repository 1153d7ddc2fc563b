"""Open loop at real time: K cohorts, each stepped once every 16 ms at its
phase slot ``k * 16 / K`` ms into the interval, whatever the earlier steps
did.  A step's latency runs from its slot (when its frame was due) to the
host seeing its output complete (a CUDA event recorded after the step,
polled).  The host spins between slots while a step is outstanding and
sleeps only to a millisecond before the next slot when none is, so neither
its sleep nor its polling adds to the program's tail.

``frame_latency_p99_ms``: the 99th percentile over every step of the window.
"""

from __future__ import annotations

import collections
import math
import statistics
import time

import torch

from benchmark.harness import Outcome, memory_peak
from benchmark.serving import Done, Served
from benchmark.trace import Trace, traced

INTERVAL_S = 0.016


def pct(xs: list, p: float) -> float:
    """The ``p``-th percentile, nearest rank."""
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(p / 100 * len(s)) - 1))]


class _Events:
    """Reused CUDA events (timed: a step's device time is read from its pair)."""

    def __init__(self, on_card: bool):
        self.on_card, self.free = on_card, []

    def get(self):
        if self.free:
            return self.free.pop()
        return torch.cuda.Event(enable_timing=True) if self.on_card else Done()

    def put(self, *evs):
        self.free.extend(evs)


def _paced(sv: Served, seconds: float, evs: _Events) -> dict:
    """Run the slots of ``seconds`` of real time; the latency, dispatch
    lateness and device time of every step."""
    K, phase = sv.K, INTERVAL_S / sv.K
    lat, late, dev_ms, enq = [], [], [], []
    pending = collections.deque()
    n_slots = int(round(seconds / INTERVAL_S)) * K
    t_start = time.perf_counter() + 0.002

    def poll():
        while pending and pending[0][2].query():
            due, e0, e1 = pending.popleft()
            lat.append(time.perf_counter() - due)
            if evs.on_card:
                dev_ms.append(e0.elapsed_time(e1))
            evs.put(e0, e1)

    for n in range(n_slots):
        due = t_start + n * phase
        while True:
            poll()
            now = time.perf_counter()
            if now >= due:
                break
            if not pending and due - now > 0.0015:
                time.sleep(due - now - 0.001)
        late.append(now - due)
        e0, e1 = evs.get(), evs.get()
        t_enq = time.perf_counter()
        e0.record()
        sv.step(n % K)
        e1.record()
        enq.append(time.perf_counter() - t_enq)
        pending.append((due, e0, e1))
    while pending:
        poll()
    return {"lat": lat, "late": late, "dev_ms": dev_ms, "enq": enq, "steps": n_slots}


def tail_parts(res: dict, share: float = 0.01) -> dict:
    """Mean ms of the slowest ``share`` of steps by latency: the latency, the
    dispatch lateness, the host's enqueue and the device time between the
    step's events; and the median enqueue of every step, for scale."""
    idx = sorted(range(len(res["lat"])), key=lambda i: -res["lat"][i])
    idx = idx[:max(1, int(share * len(idx)))]

    def mean(xs):
        return 1e3 * sum(xs[i] for i in idx) / len(idx) if xs else None

    parts = {"lat": mean(res["lat"]), "late": mean(res["late"]), "enq": mean(res["enq"]),
             "enq_p50": 1e3 * pct(res["enq"], 50)}
    if res["dev_ms"]:
        parts["dev"] = sum(res["dev_ms"][i] for i in idx) / len(idx)
    return parts


def run(ctx) -> Outcome:
    sv = Served(ctx)
    evs = _Events(ctx.device.type == "cuda")
    sv.warm(ctx.cell["warm_rounds"])
    _paced(sv, 0.25, evs)  # the loop's own calls, off the clock
    sv.rec_steps = [[] for _ in range(sv.K)]
    setup_s = ctx.setup_s()

    res = _paced(sv, ctx.seconds, evs)
    p99 = pct(res["lat"], 99) * 1e3
    ctx.log(f"{res['steps']} paced steps of {sv.B} streams, {sv.K} cohorts: latency p50 "
            f"{pct(res['lat'], 50) * 1e3:.4f} ms, p99 {p99:.4f} ms, max "
            f"{max(res['lat']) * 1e3:.4f} ms on {sv.backend}")

    trace = None
    if ctx.trace:
        trace = Trace(ctx.config, ctx.cell)
        sv.trace_mode()
        with traced(trace, ("serve.step",)):
            sub = _paced(sv, ctx.cell["trace_seconds"], evs)
        trace.counters.update(steps=sub["steps"], stream_frames=sub["steps"] * sv.B, batch=sv.B)
        trace.values.update(dispatch_late_s=res["late"], step_device_ms=res["dev_ms"],
                            latency_s=res["lat"])
    peak = memory_peak(ctx.device)
    sv.free_program()
    checks, failed, readings = sv.checks(ctx.cell["limits"]["rel_err_max"], ctx.control)
    notes = {"backend": sv.backend, "readings": readings, "tail": tail_parts(res), "latency_p50_ms": pct(res["lat"], 50) * 1e3,
             "step_device_ms_median": statistics.median(res["dev_ms"]) if res["dev_ms"] else None}
    return Outcome({"frame_latency_p99_ms": p99}, setup_s, res["steps"], failed, checks, peak,
                   trace, notes)
