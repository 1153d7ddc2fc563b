"""Headline benchmark of the port: concurrent real-time 16 kHz streams per card.

Counterpart of the repository's root ``bench.py``, on one NVIDIA GPU:

    python -m gtcrn_micro_tpu_torch.bench [--backend grid] [--budget 420]

Serving architecture = phase-staggered cohorts: K independent batches of B
streams each, one served step per cohort per 16 ms frame interval, phases
staggered so each cohort's step starts right after its frames arrive.

The step measured here is the served one, audio in -> audio out:
``serve.CohortServer(mode="audio", dft="mxu", dtype=bfloat16).step(c,
chunk)`` -- the online STFT as a GEMM, the model backend, the online iSTFT
as a GEMM, on K real cohorts whose states update in place.  ``--backend``
picks the model: ``grid`` (kernel B2, the server's default), ``step``
(kernel B1) or ``layered`` (the layered model, cuDNN and cuBLAS: the
backend the root ``bench.py`` measures; on the H100 its step is the host's,
10 ms or more, so no K passes and it verifies 0 streams).

A config is real-time iff BOTH hold with the MEASURED round-robin step time
(round-robin over K real states IS the serving schedule, not a proxy):

- keep-up:  K * step <= 16 ms   (every stream gets its frame each interval)
- latency:  step + 16/K <= 10 ms (frame arrival -> enhanced output, incl.
            worst-case phase mismatch)

The step is host wall clock around a chain that ends in
``torch.cuda.synchronize()``, less the sync round trip
(``utils.profiling.measure_rtt``): the device idles while the host enqueues
a step's kernels, and a time that left that out would overstate the
streams.  Beside each verdict a ``#`` line gives the chain's time between
two CUDA events, the device's busy time per step and its idle share
(torch.profiler).

Schedule (the root ``bench.py``'s, with this card's champions):

1. verify the champion configs FIRST, shrinking K on the last one when all
   miss -- a verified headline exists early;
2. probe K+1 at the winner while it keeps passing;
3. with budget left and the layered backend, stretch with the ``l2_psum``
   state, then ``l2_psum`` + fp8 ring storage (the fused kernels keep one
   ring layout: on them a ``#`` line says so and the phases are skipped);
4. only with remaining wall-clock budget, sweep alternative batch sizes and
   verify any that could beat the best.

A monotonic deadline (``--budget`` seconds after the first device operation,
default ``GTCRN_BENCH_BUDGET_S`` or 420) bounds every stage; SIGTERM/SIGINT
print the best *verified* result before exiting.  All '#' lines are
progress (the last names the device, backend, dtype, the verified (B, K),
its step -- host clock, CUDA events, device busy and idle share -- and the
kernel launches); exactly ONE JSON line is printed:

  {"metric": "concurrent_realtime_streams", "value": N, "unit": "streams",
   "vs_baseline": N/4096}
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time

import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.serve import (
    BACKENDS,
    FRAME_S,
    LATENCY_BUDGET_S,
    CohortPlan,
    CohortServer,
    make_backend,
    plan_cohorts,
)
from gtcrn_micro_tpu_torch.utils.profiling import busy_idle, chain_seconds, measure_rtt

HOP = 256
BASELINE_STREAMS = 4096  # north-star target of the root bench.py
# the shapes tried first, from this script's first full run on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md): 9 x 8,192 verified at 1.692
# ms/step round-robin (K=10 missed keep-up at 16.87 ms), and the sweep's
# 1.302 ms at 6,144 and 0.882 ms at 4,096 put 12 and 18 cohorts of those on
# the same 73,728-stream plateau; on a slow window one shape can miss while
# another passes, so all are tried before the sweep, and the last is the
# one walked down (its finer batch loses the fewest streams per cohort)
CHAMPIONS = ((8192, 9), (6144, 12), (4096, 18))
SWEEP = (6144, 10240, 16384, 4096)

_BEST = {"streams": 0, "cfg": None, "step_s": None, "tag": None, "detail": None,
         "emitted": False}
_DEADLINE = [float("inf")]


def _left() -> float:
    return _DEADLINE[0] - time.monotonic()


def _emit(require_verified: bool = False) -> None:
    """Print the single JSON result line (idempotent).

    ``require_verified``: the signal path -- if NOTHING has verified yet,
    print no JSON at all: a null capture is diagnosable from the progress
    lines, whereas `"value": 0` would read as "serves zero streams"."""
    if _BEST["emitted"]:
        return
    if require_verified and not _BEST["streams"]:
        print("# nothing verified before signal: no JSON (see progress "
              "lines above for where the run died)", flush=True)
        return
    _BEST["emitted"] = True
    streams = _BEST["streams"]
    print(json.dumps({
        "metric": "concurrent_realtime_streams",
        "value": streams,
        "unit": "streams",
        "vs_baseline": streams / BASELINE_STREAMS,
    }), flush=True)


def _on_signal(signum, frame):  # noqa: ARG001
    print(f"# signal {signum}: emitting best verified result and exiting",
          flush=True)
    _emit(require_verified=True)
    os._exit(0)


def max_cohorts(step_s: float) -> int:
    """Largest K meeting keep-up and latency; 0 if none."""
    return plan_cohorts(step_s, batch=0).n_cohorts


def _server(model, params, batch: int, k: int, chunk_hops: int, state_opts: dict):
    """K cohorts of the audio server on ``model``, and a zero chunk."""
    srv = CohortServer(model, params, batch=batch, n_cohorts=k, dtype=model.dtype,
                       mode="audio", dft="mxu", device=model.device,
                       chunk_hops=chunk_hops, state_opts=state_opts or None)
    chunk = torch.zeros((batch, HOP * chunk_hops), dtype=model.dtype, device=model.device)
    return srv, chunk


def measure_step_latency(model, params, batch: int, *, chain: int = 96,
                         repeats: int = 3, rtt: float = 0.0, chunk_hops: int = 1,
                         **state_opts) -> tuple[float, float, float]:
    """(median, min, max) steady-state seconds per audio streaming step at
    ``batch`` concurrent streams on the backend ``model``, over ``repeats``
    chains of ``chain`` steps of one cohort (host clock, less ``rtt``).
    ``chunk_hops`` > 1 measures the throughput-mode T-hop step (time is per
    STEP, i.e. per T hops)."""
    srv, chunk = _server(model, params, batch, 1, chunk_hops, state_opts)
    t = chain_seconds(lambda _i: srv.step(0, chunk), chain, repeats=repeats, rtt=rtt, warm=5)
    return t.median, t.min, t.max


def measure_round_robin(model, params, batch: int, k: int, *,
                        rounds: int = 20, repeats: int = 3,
                        rtt: float = 0.0, chunk_hops: int = 1,
                        detail: dict | None = None, **state_opts) -> float:
    """Median seconds per cohort step when K independent states are stepped
    round-robin (the actual serving schedule, not a single-chain proxy),
    host clock less ``rtt``.  ``chunk_hops`` > 1: throughput-mode T-hop
    steps (keep-up bound is then ``k * step <= T * 16 ms``;
    ``scripts/throughput_mode.py``).  On a card, ``detail`` (a dict) gets
    the median seconds per step between two CUDA events around each chain
    (``event_s``) and, over 2K more steps under torch.profiler, the device's
    busy seconds per step (``busy_s``), its idle share (``idle``) and its
    operations per step (``ops``)."""
    srv, chunk = _server(model, params, batch, k, chunk_hops, state_opts)
    t = chain_seconds(lambda i: srv.step(i % k, chunk), rounds * k, repeats=repeats, rtt=rtt,
                      warm=k)
    if detail is not None and t.event is not None:
        detail["event_s"] = t.event
        prof = busy_idle(lambda i: srv.step(i % k, chunk), n=2 * k)
        if prof:
            detail["busy_s"], detail["idle"], detail["ops"] = prof[0] / 1e3, prof[1], prof[2]
    return t.median


def _describe(detail: dict) -> str:
    if "event_s" not in detail:
        return "CUDA events and device idle share not measured (no card)"
    s = f"CUDA events {detail['event_s'] * 1e3:.3f} ms/step"
    if "busy_s" in detail:
        s += (f", device busy {detail['busy_s'] * 1e3:.3f} ms/step, "
              f"{detail['ops']} device operations/step, idle share {detail['idle']:.1%} "
              f"(torch.profiler)")
    else:
        s += ", torch.profiler recorded no device time: idle share not measured"
    return s


def _verify(model, params, b: int, k: int, rtt: float,
            **state_opts) -> tuple[bool, float]:
    """Round-robin verify (b, k); returns (passed, measured step seconds)."""
    tag = "+".join(state_opts) if state_opts else "ring"
    detail: dict = {}
    rr = measure_round_robin(model, params, b, k, rtt=rtt, detail=detail, **state_opts)
    plan = CohortPlan(batch=b, n_cohorts=k, step_time_s=rr)
    ok = plan.realtime_ok
    print(f"# verify K={k} x {b} [{tag}]: {rr * 1e3:.3f} ms/step "
          f"round-robin, keep-up {k * rr * 1e3:.2f}/{FRAME_S * 1e3:.0f} ms, "
          f"latency {plan.worst_latency_s * 1e3:.2f}/{LATENCY_BUDGET_S * 1e3:.0f} ms "
          f"[{'OK' if ok else 'MISS'}], "
          f"budget left {_left():.0f} s", flush=True)
    print(f"#   K={k} x {b} [{tag}]: {_describe(detail)}", flush=True)
    if ok and k * b > _BEST["streams"]:
        _BEST.update(streams=k * b, cfg=(b, k), step_s=rr, tag=tag, detail=detail)
        print(f"# best-so-far: {k * b} streams (K={k} x {b}, {tag})",
              flush=True)
    return ok, rr


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="concurrent real-time streams per card (one JSON line)")
    parser.add_argument("--backend", choices=BACKENDS, default="grid",
                        help="kernel B2 (the server's default), kernel B1, or the layered model")
    parser.add_argument("--budget", type=float,
                        default=float(os.environ.get("GTCRN_BENCH_BUDGET_S", "420")),
                        help="seconds after the first device operation")
    parser.add_argument("--device", default=None, help="default cuda; cpu runs the plain versions")
    ns = parser.parse_args(argv)
    saved = {s: signal.signal(s, _on_signal) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        _run(ns)
    finally:
        for s, handler in saved.items():
            signal.signal(s, handler)


def _run(ns) -> None:
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params

    _BEST.update(streams=0, cfg=None, step_s=None, tag=None, detail=None, emitted=False)
    dev = resolve_device(ns.device)
    # serving config: bf16 storage and activations, seeded random weights
    params = init_params(torch.Generator().manual_seed(0), device=dev)
    model = make_backend(ns.backend, params, torch.bfloat16, dev)

    t0 = time.monotonic()
    print("# attaching to device (first op)", flush=True)
    rtt = measure_rtt(device=dev)
    _DEADLINE[0] = time.monotonic() + ns.budget
    print(f"# attached in {time.monotonic() - t0:.0f} s; sync RTT "
          f"{rtt * 1e3:.3f} ms (amortized over chained steps, median of 5); "
          f"budget {ns.budget:.0f} s", flush=True)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device: {name}, backend {ns.backend} ({type(model).__name__}), dtype bf16",
          flush=True)
    print("# step = audio-in -> audio-out (online STFT GEMM + model + online "
          "iSTFT GEMM)", flush=True)

    # -- phase 1: champion configs first ------------------------------------
    for b, k in CHAMPIONS:
        if _left() < 30 or k * b <= _BEST["streams"]:
            continue
        ok, rr = _verify(model, params, b, k, rtt)
        if ok:
            break  # plateau reached; shrinking other shapes cannot beat it
        if (b, k) == CHAMPIONS[-1] and not _BEST["streams"]:
            # every champion missed: walk this shape down to what the
            # measured step time supports so SOMETHING verified is emitted
            k = min(k - 1, max_cohorts(rr))
            while k >= 1 and _left() > 30:
                ok, rr = _verify(model, params, b, k, rtt)
                if ok:
                    break
                k = min(k - 1, max_cohorts(rr))

    # -- phase 2: K+1 probes at the best verified config --------------------
    while _BEST["streams"] and _left() > 45:
        b, k = _BEST["cfg"]
        ok, _ = _verify(model, params, b, k + 1, rtt)
        if not ok:
            break

    # -- phases 2b/2c: stretch with the l2_psum state, then l2_psum + fp8 ----
    # ring storage (the layered model's init_state options, which
    # CohortServer serves through state_opts)
    if ns.backend != "layered":
        print(f"# l2_psum and fp8 stretch skipped: the {ns.backend} backend's "
              f"kernel keeps one ring layout (the layered model's init_state "
              f"options only)", flush=True)
    else:
        for opts in ({"l2_psum": True},
                     {"l2_psum": True, "store_dtype": torch.float8_e4m3fn}):
            if _BEST["streams"] and _left() > 120:
                b, k = _BEST["cfg"]
                while _left() > 60:
                    ok, _ = _verify(model, params, b, k + 1, rtt, **opts)
                    if not ok:
                        break
                    k += 1

    # -- phase 3: sweep alternates with remaining budget ---------------------
    for cand in SWEEP:
        if _left() < 150:
            print(f"# budget: skipping sweep at batch {cand}", flush=True)
            break
        try:
            med, lo, hi = measure_step_latency(model, params, cand, rtt=rtt)
        except torch.cuda.OutOfMemoryError:
            print(f"# batch {cand:6d}: out of memory, skipped", flush=True)
            continue
        kk = max_cohorts(med)
        print(f"# batch {cand:6d}: {med * 1e3:7.3f} ms/step "
              f"[{lo * 1e3:.3f},{hi * 1e3:.3f}] -> K={kk} ideal = "
              f"{kk * cand:6d} streams", flush=True)
        while kk * cand > _BEST["streams"] and kk >= 1 and _left() > 60:
            ok, rr = _verify(model, params, cand, kk, rtt)
            if ok:
                # opportunistic K+1 at the new winner too
                while _left() > 45:
                    ok2, _ = _verify(model, params, cand, kk + 1, rtt)
                    if not ok2:
                        break
                    kk += 1
                break
            kk = min(kk - 1, max_cohorts(rr))

    verified = None
    if _BEST["streams"]:
        b, k = _BEST["cfg"]
        verified = {"batch": b, "cohorts": k, "step_s": _BEST["step_s"], "state": _BEST["tag"],
                    **(_BEST["detail"] or {})}
    print("# verified: " + json.dumps({
        "device": name, "backend": ns.backend, "dtype": "bf16", "plan": verified,
        "launches": getattr(model, "launches", None)}), flush=True)
    _emit()


if __name__ == "__main__":
    main()
