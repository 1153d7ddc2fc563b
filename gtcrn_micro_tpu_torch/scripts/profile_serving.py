"""Trace the bf16 serving step on one GPU and break down its device time.

Counterpart of the root ``scripts/profile_serving.py``.  Times
:data:`CHAIN` chained steps at a given batch (host clock less the sync
round trip), then takes a ``torch.profiler`` trace of :data:`TRACED_STEPS`
more and prints the device time
grouped by kernel category (:func:`categorize`), the device's idle share of
the host wall clock, and the top operations.

By default the step is the backend's model step on spectra; ``--audio``
steps the served ``CohortServer`` (online STFT GEMM, model, online iSTFT
GEMM).  ``--chunk T`` (layered backend) steps T hops at a time;
``--folded`` (layered backend) serves BatchNorm-folded params.

    python -m gtcrn_micro_tpu_torch.scripts.profile_serving [batch] [--backend grid] [--audio]
"""

from __future__ import annotations

import argparse
import collections

import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.serve import BACKENDS, make_backend
from gtcrn_micro_tpu_torch.utils.profiling import chain_seconds, device_events, measure_rtt

CHAIN = 200  # steps timed
TRACED_STEPS = 10  # steps traced


def categorize(name: str) -> str:
    """The category of a CUDA kernel (or runtime operation) by its name."""
    n = name.lower()
    if "fused_step" in n:
        return "kernel B1"
    if "fused_grid" in n:
        return "kernel B2"
    if "nccl" in n:
        return "NCCL"
    if any(s in n for s in ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm", "winograd")):
        return "conv"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "xmma", "splitk", "_int_mm")):
        return "GEMM"
    if any(s in n for s in ("memcpy", "memset", "copy")):
        return "copy"
    if "reduce" in n or "reduction" in n:
        return "reduction"
    if "elementwise" in n:
        return "elementwise"
    return "other"


def breakdown(evs, wall_us: float, steps: int) -> dict:
    """Print the device time of ``evs`` (``utils.profiling.device_events``)
    by category and the top 25 operations; returns {category: ms per step}
    with the device's busy ms per step and idle share."""
    by_cat: collections.Counter = collections.Counter()
    by_name: collections.Counter = collections.Counter()
    for e in evs:
        dur = e.time_range.elapsed_us()
        by_cat[categorize(e.name)] += dur
        by_name[e.name] += dur
    total = sum(by_cat.values())
    if total == 0:
        print("torch.profiler recorded no device time: breakdown not measured", flush=True)
        return {}
    print(f"\ndevice total {total / 1e3:.2f} ms over {steps} steps "
          f"({total / steps / 1e3:.3f} ms/step, {len(evs) / steps:.0f} operations/step); "
          f"host wall {wall_us / steps / 1e3:.3f} ms/step; idle share {1 - total / wall_us:.1%} "
          f"(profiler on)")
    print("\nby category (ms over all steps):")
    for cat, dur in by_cat.most_common():
        print(f"  {dur / 1e3:8.2f}  {100 * dur / total:5.1f}%  {cat}")
    print("\ntop 25 ops:")
    for opname, dur in by_name.most_common(25):
        print(f"  {dur / 1e3:8.2f}  {100 * dur / total:5.1f}%  {opname[:110]}", flush=True)
    res = {cat: dur / steps / 1e3 for cat, dur in by_cat.items()}
    res.update(busy_ms=total / steps / 1e3, idle=1 - total / wall_us)
    return res


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="device-time breakdown of the serving step")
    parser.add_argument("batch", type=int, nargs="?", default=16384)
    parser.add_argument("--backend", choices=BACKENDS, default="grid")
    parser.add_argument("--audio", action="store_true", help="the served audio step")
    parser.add_argument("--chunk", type=int, default=1, help="hops per step (layered)")
    parser.add_argument("--folded", action="store_true", help="BatchNorm-folded params (layered)")
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(argv)

    from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params

    dev = resolve_device(ns.device)
    params = init_params(torch.Generator().manual_seed(0), device=dev)
    if ns.folded:
        from gtcrn_micro_tpu_torch.models.folding import fold_bn_params

        params = fold_bn_params(params)
    model = make_backend(ns.backend, params, torch.bfloat16, dev)
    batch, chunk = ns.batch, ns.chunk
    if ns.audio:
        from gtcrn_micro_tpu_torch.serve import CohortServer

        srv = CohortServer(model, params, batch=batch, n_cohorts=1, dtype=torch.bfloat16,
                           mode="audio", dft="mxu", device=dev, chunk_hops=chunk)
        x = torch.zeros((batch, 256 * chunk), dtype=torch.bfloat16, device=dev)

        def step(_i):
            return srv.step(0, x)
    else:
        state = model.init_state(batch)
        spec = torch.zeros((batch, 257, chunk, 2), dtype=torch.bfloat16, device=dev)

        def step(_i):
            return model.step(state, spec)[0]

    rtt = measure_rtt(device=dev)
    lat = chain_seconds(step, CHAIN, repeats=1, rtt=rtt).median
    print(f"batch {batch} backend={ns.backend} folded={ns.folded} audio={ns.audio} "
          f"chunk={chunk}: {lat * 1e3:.3f} ms/step "
          f"({lat / chunk * 1e3:.3f} ms/frame, "
          f"{lat / chunk / batch * 1e9:.0f} ns/stream-frame)", flush=True)
    res = {"step_s": lat}
    if dev.type != "cuda":
        print("device breakdown not measured: no card", flush=True)
        return res
    evs, wall_us = device_events(step, TRACED_STEPS)
    res.update(breakdown(evs, wall_us, TRACED_STEPS))
    return res


if __name__ == "__main__":
    main()
