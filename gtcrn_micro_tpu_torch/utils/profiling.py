"""Profiling helpers: ``torch.profiler`` traces and step timing (the JAX
package's ``utils/profiling.py``).

The reference times with wall-clock prints.  Here a trace is a Chrome trace
(Perfetto, ``chrome://tracing``) of the host and, on a card, the device; a
step on the card is timed by CUDA events around many calls, and by the host
clock only where the caller asks for the CPU.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time

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
