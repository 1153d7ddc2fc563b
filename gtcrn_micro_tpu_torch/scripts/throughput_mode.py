"""Throughput-mode serving: verified max streams with T-hop chunked steps.

Counterpart of the root ``scripts/throughput_mode.py``.  The headline
bench (``gtcrn_micro_tpu_torch.bench``) holds the 10 ms interactive latency
budget, which caps chunking at T=1 (any T>1 buffers (T-1)*16 ms of input).
Many deployments (batch transcription feeds, call recording, broadcast
monitoring) only need KEEP-UP -- every stream processed at real-time rate
-- and tolerate tens of ms of latency.  There T-hop chunked ring steps
amortise the host's per-operation dispatch over T hops.

This script verifies throughput-mode cohort plans the same way the bench
verifies the headline: ROUND-ROBIN over K real state sets (the actual
schedule), keep-up criterion ``K * step <= T * 16 ms``.  The reported
latency is the plan's own contract (``CohortPlan.worst_latency_s``),
printed next to each verified row -- these numbers do NOT compete with the
10 ms headline, they answer "how many streams can one card keep up with if
latency is relaxed?".

Only the layered backend (the default here) steps T > 1 hops at a time; the
fused kernels step one hop at a time, so with ``--backend grid`` or
``step`` the script runs T=1 only and says so.

    python -m gtcrn_micro_tpu_torch.scripts.throughput_mode [--backend layered]
"""

from __future__ import annotations

import argparse
import time

import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.serve import BACKENDS, FRAME_S, CohortPlan, make_backend

HOPS = (2, 4, 8, 16)  # chunk sizes T (layered backend)
BATCHES = (12288, 16384, 20480)


def keep_up(batch: int, k: int, t: int, step_s: float) -> tuple[bool, float, int]:
    """(keep-up verdict, worst latency seconds, streams) of K cohorts of
    ``batch`` streams stepped ``t`` hops at a time in ``step_s``."""
    plan = CohortPlan(batch=batch, n_cohorts=k, step_time_s=step_s, chunk_hops=t)
    return plan.keep_up_ok, plan.worst_latency_s, plan.streams


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="keep-up-verified streams at T-hop steps")
    parser.add_argument("--backend", choices=BACKENDS, default="layered")
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(argv)

    from gtcrn_micro_tpu_torch.bench import measure_round_robin, measure_step_latency
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
    from gtcrn_micro_tpu_torch.utils.profiling import measure_rtt

    dev = resolve_device(ns.device)
    params = init_params(torch.Generator().manual_seed(0), device=dev)
    model = make_backend(ns.backend, params, torch.bfloat16, dev)
    hops = HOPS
    if ns.backend != "layered":
        print(f"# the {ns.backend} backend's kernel steps one hop at a time: T=1 only",
              flush=True)
        hops = (1,)
    t0 = time.monotonic()
    rtt = measure_rtt(device=dev)
    print(f"# attached in {time.monotonic() - t0:.0f} s, RTT {rtt * 1e3:.3f} ms; "
          f"backend {ns.backend}", flush=True)

    best = {"streams": 0, "row": None}

    def verify(b: int, k: int, t: int) -> bool:
        rr = measure_round_robin(model, params, b, k, rtt=rtt, chunk_hops=t)
        ok, lat, streams = keep_up(b, k, t, rr)
        print(f"# T={t} K={k} x {b}: {rr * 1e3:.3f} ms/step round-robin, "
              f"keep-up {k * rr * 1e3:.2f}/{t * 16} ms "
              f"[{'OK' if ok else 'MISS'}], latency "
              f"{lat * 1e3:.1f} ms, {streams} streams", flush=True)
        if ok and streams > best["streams"]:
            best["streams"] = streams
            best["row"] = (b, k, t, rr, lat)
        return ok

    # single-chain scouting: per-step time at candidate batches and T
    for t in hops:
        for b in BATCHES:
            med, lo, hi = measure_step_latency(model, params, b, rtt=rtt, chunk_hops=t)
            k_ideal = int(t * FRAME_S / med)
            print(f"# scout T={t} batch {b}: {med * 1e3:.3f} ms/step "
                  f"[{lo * 1e3:.3f},{hi * 1e3:.3f}] -> K<={k_ideal} ideal "
                  f"= {k_ideal * b} streams", flush=True)
            # verify the ideal plan (and probe K+1 on a pass)
            k = k_ideal
            while k >= 1:
                if verify(b, k, t):
                    while verify(b, k + 1, t):
                        k += 1
                    break
                k -= 1

    if best["row"]:
        b, k, t, rr, lat = best["row"]
        print(f"RESULT: {best['streams']} streams keep-up-verified "
              f"(T={t}, K={k} x {b}, {rr * 1e3:.3f} ms/step, "
              f"worst-case latency {lat * 1e3:.1f} ms)", flush=True)
    else:
        print("RESULT: no throughput-mode plan verified", flush=True)
    return best


if __name__ == "__main__":
    main()
