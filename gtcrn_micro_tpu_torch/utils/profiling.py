"""Profiling helpers: ``torch.profiler`` traces, step timing, and the
program's own spans and counters (the JAX package's ``utils/profiling.py``).

The reference times with wall-clock prints.  Here a trace is a Chrome trace
(Perfetto, ``chrome://tracing``) of the host and, on a card, the device; a
step on the card is timed by CUDA events around many calls, and by the host
clock only where the caller asks for the CPU.  ``chain_seconds`` is the
measuring scripts' timing loop: chains of calls that end in a synchronize,
on the host clock less the sync round trip, with CUDA events beside it.
``device_events``, ``busy_idle`` and ``idle_share`` read the card's
operations of a few back-to-back calls (torch.profiler): the device's busy
time and its idle share of the host's wall clock.

``span`` and ``count`` record where the port's served step and offline entry
point spend host time, while a ``torch.profiler`` session is on and only
then (``tracing``); ``recorded`` returns what they kept (see :func:`span`).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import statistics
import tempfile
import threading
import time
from typing import NamedTuple

import torch

from gtcrn_micro_tpu_torch import resolve_device


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``with trace(dir) as path: ...`` -> a Chrome trace of the block at
    ``path`` (``dir/trace.json``; a temporary directory by default), with
    the CUDA activity when a card is present."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "gtcrn_micro_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(log_dir, "trace.json")
    with torch.profiler.profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


def sync(x: torch.Tensor) -> float:
    """Wait for ``x``'s device and return its first value."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(x.reshape(-1)[0])


def measure_rtt(iters: int = 5, device=None) -> float:
    """Median seconds of one tiny operation on ``device`` and the fetch of
    its value to the host (the fixed cost of a host read)."""
    dev = resolve_device(device)
    x = torch.zeros((8, 128), device=dev)
    sync(x + 1.0)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(x + 1.0)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def time_fn(fn, *args, iters: int = 100, device=None, **kwargs) -> float:
    """Seconds per call of ``fn(*args, **kwargs)`` over ``iters`` calls with
    the same arguments, after one warm-up call.  On a card (``device`` None
    means ``cuda``) by CUDA events around the calls; on the CPU, when the
    caller asks for it, by the host clock.  ``fn`` may not take an argument
    named ``device`` through here."""
    dev = resolve_device(device)
    fn(*args, **kwargs)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


class ChainTimes(NamedTuple):
    """Seconds per call of a timed chain (:func:`chain_seconds`)."""

    median: float
    min: float
    max: float
    event: float | None  # median between two CUDA events; None off the card


def chain_seconds(fn, n: int, *, repeats: int = 3, rtt: float = 0.0,
                  warm: int = 1) -> ChainTimes:
    """Seconds per call of ``fn(i)`` (which returns a tensor) over ``repeats``
    chains of ``n`` calls ``fn(0) .. fn(n - 1)``, each chain ended by a
    synchronize on its last result: on the host clock less ``rtt`` (the
    sync round trip) the median, min and max, and on a card the median
    between two CUDA events around each chain.  ``fn(0) .. fn(warm - 1)``
    and a synchronize come first."""
    out = None
    for i in range(warm):
        out = fn(i)
    sync(out)
    on_card = out.device.type == "cuda"
    lats, events = [], []
    for _ in range(repeats):
        if on_card:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        for i in range(n):
            out = fn(i)
        if on_card:
            e1.record()
        sync(out)
        lats.append(max(time.perf_counter() - t0 - rtt, 1e-9) / n)
        if on_card:
            events.append(e0.elapsed_time(e1) / 1e3 / n)
    lats.sort()
    events.sort()
    return ChainTimes(lats[len(lats) // 2], lats[0], lats[-1],
                      events[len(events) // 2] if events else None)


def device_events(fn, n: int):
    """The device operations of ``n`` back-to-back calls ``fn(i)`` on the
    card (torch.profiler), by start time, and the host wall clock (us) over
    them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    return evs, wall_us


def _busy_idle(evs, wall_us: float, n: int) -> tuple[float, float, int] | None:
    busy = sum(e.time_range.elapsed_us() for e in evs)
    if busy == 0:
        return None
    return busy / n / 1e3, 1 - busy / wall_us, len(evs) // n


def busy_idle(fn, n: int = 10) -> tuple[float, float, int] | None:
    """(device busy ms per call, idle share of the host wall clock, device
    operations per call) over ``n`` back-to-back calls ``fn(i)`` on the card;
    None when torch.profiler recorded no device time."""
    return _busy_idle(*device_events(fn, n), n)


def idle_share(fn, n: int = 10, top: int = 5) -> str:
    """:func:`busy_idle` as a line, with the host wall clock per call and the
    ``top`` device operations by their device time per call."""
    evs, wall_us = device_events(fn, n)
    summary = _busy_idle(evs, wall_us, n)
    if summary is None:
        return "torch.profiler recorded no device time: idle share not measured"
    busy_ms, idle, ops = summary
    by_name: dict[str, list] = {}
    for e in evs:
        acc = by_name.setdefault(e.name[:48], [0, 0.0])
        acc[0] += 1
        acc[1] += e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    tops = "; ".join(f"{name} x{c / n:.0f} {us / n / 1e3:.3f} ms" for name, (c, us) in ranked)
    return (f"device busy {busy_ms:.3f} ms of {wall_us / n / 1e3:.3f} ms wall per step, "
            f"{ops} device operations per step, idle share {idle:.1%} (torch.profiler, {n} "
            f"steps, host clock, profiler on); top by device time per step: {tops}")


# -- the program's spans and counters ---------------------------------------

SPAN_LIMIT = 1 << 20  # spans kept; the oldest go first


class Span(NamedTuple):
    """One closed :func:`span`.  Times are ``time.time_ns()``, the clock of
    ``torch.profiler``'s host events.  ``parent``: the index in
    :attr:`Recorded.spans` of the span that enclosed it on its thread (None
    at a root, or where that span is still open or was dropped)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    request: object


class Recorded(NamedTuple):
    spans: list     # [Span], in the order they closed
    counters: dict  # name -> total


_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_SPANS: collections.deque = collections.deque(maxlen=SPAN_LIMIT)
_COUNTERS: dict = {}
_SEQ = itertools.count()  # span ids, never reset, so a root's id names its request
_OPEN = threading.local()


def _open_spans() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


class _Span:
    __slots__ = ("name", "request", "seq", "parent", "fn", "t0")

    def __init__(self, name: str, request):
        self.name, self.request = name, request

    def __enter__(self):
        stack = _open_spans()
        top = stack[-1] if stack else None
        self.seq = next(_SEQ)
        self.parent = top.seq if top else None
        if self.request is None:
            self.request = top.request if top else self.seq
        # a FUNCTION-scope range: a record_function (user-scope) range also
        # gets a copy on the device's timeline, where a reader of the trace
        # takes it for a device operation
        self.fn = torch._C._profiler._RecordFunctionFast(self.name)
        self.fn.__enter__()
        self.t0 = time.time_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.fn.__exit__(*exc)
        _open_spans().pop()
        with _LOCK:
            _SPANS.append((self.seq, self.name, self.t0, t1, self.parent, self.request))
        return False


def tracing() -> bool:
    """Whether a ``torch.profiler`` session is on, so that spans and counters
    record: a caller computes a span's request or a count only then."""
    return torch.autograd._profiler_enabled()


def span(name: str, request=None):
    """``with span(name): ...`` records the block as a span while a
    ``torch.profiler`` session is on: a range of that name in the profiler's
    trace, and ``(name, start_ns, end_ns, parent, request)`` in memory
    (:func:`recorded`).  ``request`` names the request the span serves; by
    default the enclosing span's, or at a root the span's own id.  Off, it
    returns one shared context that does nothing, so a span costs one check
    of the profiler's state."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, request)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a ``torch.profiler`` session
    is on."""
    if torch.autograd._profiler_enabled():
        with _LOCK:
            _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def recorded() -> Recorded:
    """The spans and counters recorded since the last :func:`clear`."""
    with _LOCK:
        raw, counters = list(_SPANS), dict(_COUNTERS)
    at = {r[0]: i for i, r in enumerate(raw)}
    return Recorded([Span(name, a, b, at.get(parent), request)
                     for _, name, a, b, parent, request in raw], counters)


def clear() -> None:
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()
