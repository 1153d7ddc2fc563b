"""The traced sub-window: what ``torch.profiler`` saw on the device and the
harness's own host spans, reduced to what the per-layer readers and the
``breakdown`` need.

Host spans are ``torch.profiler.record_function`` ranges the harness opens
around its calls into the program (``serve.step``, ``loader.next``,
``train.step``, ``enhance_wavs``); the window itself is the span
``bench.window``.  Device and host times come from the same trace, so an
idle gap on the device is labelled by the innermost span the host was in
when it began.
"""

from __future__ import annotations

import contextlib

import torch

WINDOW = "bench.window"


class Trace:
    """One traced sub-window.  ``device_ops``: (name, start_ns, end_ns) of
    every kernel, copy and fill on the device; ``spans``: (name, start_ns,
    end_ns) of the harness's host spans; ``counters`` and ``values``: what
    the traffic driver counted and timed in the sub-window (numbers, and
    lists of seconds); ``config``, ``cell``: the cell's files."""

    def __init__(self, config: dict, cell: dict):
        self.config, self.cell = config, cell
        self.device_ops: list = []
        self.spans: list = []
        self.counters: dict = {}
        self.values: dict = {}
        self.t0 = self.t1 = 0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _intervals(self) -> list:
        out = []
        for _, a, b in sorted(self.device_ops, key=lambda o: o[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device."""
        return sum(b - a for a, b in self._intervals()) / 1e9

    def device_s(self, names, exclude: bool = False) -> float:
        """Summed device seconds in the window of the operations whose names
        contain one of ``names`` (of all the others with ``exclude``)."""
        total = 0
        for name, a, b in self.device_ops:
            if any(n in name for n in names) != exclude:
                total += max(0, min(b, self.t1) - max(a, self.t0))
        return total / 1e9

    def span_s(self, name: str) -> list:
        return [(b - a) / 1e9 for n, a, b in self.spans if n == name]

    def top_ops(self, k: int = 10) -> list:
        by: dict = {}
        for name, a, b in self.device_ops:
            by[name[:120]] = by.get(name[:120], 0) + (b - a)
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest gaps with nothing on the device, each labelled by
        the innermost harness span open on the host when it began."""
        iv = self._intervals()
        edges = [self.t0] + [x for ab in iv for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        spans = sorted((s for s in self.spans if s[0] != WINDOW), key=lambda s: s[1])
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            inner = [s for s in spans if s[1] <= a < s[2]]
            label = min(inner, key=lambda s: s[2] - s[1])[0] if inner else "harness"
            out.append([label, (b - a) / 1e9])
        return out


@contextlib.contextmanager
def traced(trace: Trace, span_names: tuple):
    """Profile the block as the window ``bench.window``; fill ``trace`` with
    its device operations and the host spans named in ``span_names``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield
            sync()
    names = set(span_names) | {WINDOW}
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.name() in names:  # a span, or its copy on the device's timeline
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                trace.spans.append((e.name(), start, end))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            trace.device_ops.append((e.name(), start, end))
    win = [s for s in trace.spans if s[0] == WINDOW]
    trace.t0, trace.t1 = win[0][1], win[0][2]
