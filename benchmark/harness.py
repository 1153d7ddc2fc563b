"""What every traffic driver shares: the run's context (with its set-up
clock), the memory peak, and the checks that decide ``correct``.

A driver is a module ``benchmark/traffic/<kind>.py`` with one function
``run(ctx) -> Outcome``: it sets the cell up (timed as ``setup_s``), warms
every shape the window uses, measures for ``ctx.seconds``, traces a bounded
sub-window when ``ctx.trace``, reads the memory peak, frees the program's
state and compares what the window produced with the plain reference in
``benchmark/reference``.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch


@dataclasses.dataclass
class Ctx:
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: dict        # benchmark/configs/<config>.json
    cell: dict          # benchmark/cells/<cell>.json
    control: bool = False  # also read the control's numbers (calibration)
    started: float = dataclasses.field(default_factory=time.perf_counter)

    def setup_s(self) -> float:
        """Seconds since the run started (process start, for a run of the
        command): the set-up time when called at the window's start."""
        return time.perf_counter() - self.started

    def log(self, msg: str) -> None:
        print(f"# {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Check:
    """One number compared, with its limit: the run is correct when every
    ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN is never ok


@dataclasses.dataclass
class Outcome:
    metrics: dict           # end-to-end metric name -> value (without setup_s)
    setup_s: float
    attempted: int
    failed: int
    checks: list            # [Check]
    memory_peak_bytes: int
    trace: object = None    # benchmark.trace.Trace of the sub-window, or None
    notes: dict = dataclasses.field(default_factory=dict)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def rel_gap(a: float, b: float, floor: float) -> float:
    """|a - b| over max(|b|, floor)."""
    return abs(a - b) / max(abs(b), floor)


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Per leaf, the gap between the program's norm of the leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: rel_gap(float(torch.linalg.vector_norm(prog[k].double())), norms[k], med)
            for k in ref}


def worst(gaps: dict) -> tuple[float, str]:
    """The largest of ``gaps`` (NaN counts as largest) and its key."""
    at = max(gaps, key=lambda k: float("inf") if gaps[k] != gaps[k] else gaps[k])
    return gaps[at], at


def worst_leaf_gap(prog: dict, ref: dict) -> tuple[float, str]:
    """The largest of :func:`leaf_gaps` and its leaf."""
    return worst(leaf_gaps(prog, ref))
