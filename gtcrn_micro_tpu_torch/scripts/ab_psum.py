"""A/B of the layered model's state layouts on the served audio step.

Counterpart of the root ``scripts/ab_psum.py``.  The served step (online
STFT as a GEMM -> the layered model's ring step -> online iSTFT, bf16;
``CohortServer(mode="audio")`` on the ``layered`` backend) at the cohort
batches, with four states:

- ``ring``: every temporal cache is an input ring;
- ``psum``: the 14 L == 2 caches carry their two partial OUTPUT frames
  instead (``l2_psum``);
- ``fp8``: the rings are stored in ``torch.float8_e4m3fn`` and cast on read;
- ``psum+fp8``: both.

Only the layered backend has these states: the fused kernels keep one ring
layout.  Each variant is timed by the port bench's ``measure_step_latency``
(one chain) or, with ``--rr K``, ``measure_round_robin`` over K real states
(the serving schedule), in two interleaved orders (forward, then reversed,
against drift), and each ratio to ``ring`` takes each variant's best of
the two.

    python -m gtcrn_micro_tpu_torch.scripts.ab_psum [--rr K] [batches...] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from gtcrn_micro_tpu_torch import resolve_device

VARIANTS = {
    "ring": {},
    "psum": {"l2_psum": True},
    "fp8": {"store_dtype": torch.float8_e4m3fn},
    # the L == 2 caches stay compute-dtype partials, the L >= 4 rings store fp8
    "psum+fp8": {"l2_psum": True, "store_dtype": torch.float8_e4m3fn},
}
BATCHES = (8192, 12288)
CHAIN = 96    # steps per chain (the bench's default)
REPEATS = 5   # chains per measurement
ROUNDS = 20   # round-robin rounds per chain (the bench's default)


def main(argv=None) -> dict:
    from gtcrn_micro_tpu_torch.bench import measure_round_robin, measure_step_latency
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
    from gtcrn_micro_tpu_torch.serve import make_backend
    from gtcrn_micro_tpu_torch.utils.profiling import measure_rtt

    parser = argparse.ArgumentParser(description="ring vs l2_psum vs fp8 state on the audio step")
    parser.add_argument("--rr", type=int, default=0,
                        help="measure the K-state round-robin schedule instead of one chain")
    parser.add_argument("batches", nargs="*", type=int, default=list(BATCHES))
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(argv)
    dev = resolve_device(ns.device)
    params = init_params(torch.Generator().manual_seed(0), device=dev)
    model = make_backend("layered", params, torch.bfloat16, dev)
    rtt = measure_rtt(device=dev)
    print(f"# RTT {rtt * 1e3:.3f} ms; layered bf16 audio step on {dev.type}", flush=True)
    names = list(VARIANTS)
    res = {}
    for b in ns.batches:
        meds = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                if ns.rr:
                    med = measure_round_robin(model, params, b, ns.rr, rounds=ROUNDS,
                                              repeats=REPEATS, rtt=rtt, **VARIANTS[name])
                    lo = hi = med
                else:
                    med, lo, hi = measure_step_latency(model, params, b, chain=CHAIN,
                                                       repeats=REPEATS, rtt=rtt, **VARIANTS[name])
                meds[name].append(med)
                print(f"batch {b:6d} {name:8s}: {med * 1e3:7.3f} ms/step "
                      f"[{lo * 1e3:.3f},{hi * 1e3:.3f}]"
                      + (f" keep-up {ns.rr * med * 1e3:.2f}/16 ms" if ns.rr else ""), flush=True)
        base = min(meds["ring"])
        ratios = {}
        for name in names[1:]:
            r = ratios[name] = min(meds[name]) / base
            print(f"batch {b:6d} {name}/ring (best-of-2 runs): {r:.3f}x "
                  f"({(1 - r) * 100:+.1f}% step time)", flush=True)
        res[b] = {"best_s": {n: min(v) for n, v in meds.items()}, "ratios": ratios}
    return res


if __name__ == "__main__":
    main()
