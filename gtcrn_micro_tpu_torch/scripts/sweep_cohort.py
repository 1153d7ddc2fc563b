"""Cohort round-robin serving sweep (phase-staggered batches), on one GPU.

Counterpart of the root ``scripts/sweep_cohort.py``.  A real-time serving
deployment need not put every stream in ONE batched step: the card can run
K independent cohorts of B streams, one step each per 16 ms frame
interval, phases staggered so each cohort's step starts right after its
frames arrive.  Constraints for honesty:

- keep-up:   K * step_time <= 16 ms (one frame per stream per interval)
- latency:   16/K ms (max phase mismatch) + step_time <= 10 ms budget

This measures (a) the per-batch curve of the model step on spectra (the
backend's ``step``, no DSP) with medians of 3 chains, and (b) the ACTUAL
aggregate rate of stepping K independent states round-robin (same
backend, K state sets), to confirm cohorts cost what single-chain timing
predicts.  Host clock around chains that end in a synchronize, less the
sync round trip.

    python -m gtcrn_micro_tpu_torch.scripts.sweep_cohort [--backend grid]
"""

from __future__ import annotations

import argparse

import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.bench import max_cohorts
from gtcrn_micro_tpu_torch.serve import BACKENDS, FRAME_S, make_backend
from gtcrn_micro_tpu_torch.utils.profiling import chain_seconds, measure_rtt

BATCHES = (2048, 4096, 6144, 8192, 12288, 16384)
CHAIN = 160  # steps per timed chain of the curve
ROUNDS = 40  # round-robin rounds


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="per-batch step curve and round-robin check")
    parser.add_argument("--backend", choices=BACKENDS, default="grid")
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(argv)

    dev = resolve_device(ns.device)
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params

    params = init_params(torch.Generator().manual_seed(0), device=dev)
    model = make_backend(ns.backend, params, torch.bfloat16, dev)
    rtt = measure_rtt(device=dev)
    print(f"# sync RTT {rtt * 1e3:.3f} ms; backend {ns.backend}", flush=True)

    results = {}
    for b in BATCHES:
        spec = torch.zeros((b, 257, 1, 2), dtype=torch.bfloat16, device=dev)
        state = [model.init_state(b)]

        def step(_i):
            out, state[0] = model.step(state[0], spec)
            return out

        t = chain_seconds(step, CHAIN, rtt=rtt, warm=5)
        med = t.median
        results[b] = med
        k = max_cohorts(med)
        print(f"batch {b:6d}: {med * 1e3:7.3f} ms/step "
              f"[{t.min * 1e3:.3f},{t.max * 1e3:.3f}]  "
              f"-> K={k} cohorts = {k * b} streams "
              f"(worst latency {(med + FRAME_S / max(k, 1)) * 1e3:.2f} ms)",
              flush=True)
        del state

    # empirical round-robin verification at the best config
    best_b = max(results, key=lambda b: b * max_cohorts(results[b]))
    med = results[best_b]
    k = max_cohorts(med)
    res = {"curve_s": results, "batch": best_b, "cohorts": k, "single_chain_s": med}
    if k == 0:
        print("\n# no batch keeps up: no round-robin to verify", flush=True)
        return res
    print(f"\n# verifying round-robin: K={k} x batch {best_b} "
          f"= {k * best_b} streams", flush=True)
    spec = torch.zeros((best_b, 257, 1, 2), dtype=torch.bfloat16, device=dev)
    states = [model.init_state(best_b) for _ in range(k)]

    def rr_step(i):
        out, states[i % k] = model.step(states[i % k], spec)
        return out

    per_step = chain_seconds(rr_step, ROUNDS * k, repeats=1, rtt=rtt, warm=k).median
    per_round = per_step * k
    print(f"round-robin: {per_round * 1e3:.3f} ms per K-round "
          f"({per_step * 1e3:.3f} ms/step vs single-chain {med * 1e3:.3f}); "
          f"keep-up {'OK' if per_round <= FRAME_S else 'FAIL'} "
          f"({per_round * 1e3:.2f} <= 16 ms), "
          f"worst latency {(per_step + FRAME_S / k) * 1e3:.2f} ms",
          flush=True)
    res.update(round_robin_s=per_step, keep_up=per_round <= FRAME_S)
    return res


if __name__ == "__main__":
    main()
