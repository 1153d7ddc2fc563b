"""Throughput of the full-integer int8 serving step (``ops/int8_step.py``
``Int8Serving``, products by ``torch._int_mm``) on one GPU.

Counterpart of the root ``scripts/bench_int8.py``: seeded random weights,
int8 activation ranges calibrated on seeded noise spectra, chains of
``--chain`` steps from in-place state between two synchronizes, host clock
less the sync round trip.  Prints ms per frame, ns per stream and the
real-time verdict (a step under the 10 ms budget) per batch.

    python -m gtcrn_micro_tpu_torch.scripts.bench_int8 [batches...] [--chain 200]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.utils.profiling import chain_seconds, measure_rtt

BATCHES = (4096, 16384, 32768, 49152)


def chain_latency(step, state, spec, rtt: float, n: int = 200) -> float:
    """Seconds per ``step(state, spec)`` over a chain of ``n`` after 6 warm
    steps, host clock less ``rtt``."""
    box = [state]

    def one(_i):
        out, box[0] = step(box[0], spec)
        return out

    return chain_seconds(one, n, repeats=1, rtt=rtt, warm=6).median


def rt_verdict(step_s: float) -> str:
    """"RT" when one step of every stream fits the 10 ms budget."""
    return "RT" if step_s < 0.010 else "over"


def calibrated_act_qp(params: dict, device) -> dict:
    """int8 activation params from the ranges of four seeded noise spectra
    of 16 frames (scale 0.3) through the layered model."""
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro
    from gtcrn_micro_tpu_torch.quant.ptq import observe_ranges, qparams_from_ranges

    rng = np.random.default_rng(0)
    calib = rng.standard_normal((4, 257, 16, 2)).astype(np.float32) * 0.3
    ranges = observe_ranges(GTCRNMicro.from_params(params, device=device), calib, batch_size=4)
    return qparams_from_ranges(ranges, 8, device=device)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="int8 serving step per batch")
    parser.add_argument("batches", nargs="*", type=int, default=list(BATCHES))
    parser.add_argument("--chain", type=int, default=200)
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(argv)

    from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
    from gtcrn_micro_tpu_torch.ops.int8_step import Int8Serving

    dev = resolve_device(ns.device)
    params = init_params(torch.Generator().manual_seed(0), device=dev)
    serving = Int8Serving(params, calibrated_act_qp(params, dev), device=dev)

    rtt = measure_rtt(device=dev)
    print(f"# sync RTT {rtt * 1e3:.3f} ms", flush=True)
    res = {}
    for batch in ns.batches:
        try:
            state = serving.init_state(batch)
            spec = torch.zeros((batch, 257, 1, 2), dtype=torch.bfloat16, device=dev)
            lat = chain_latency(serving.step, state, spec, rtt, n=ns.chain)
        except torch.cuda.OutOfMemoryError:
            print(f"batch {batch}: out of memory, skipped", flush=True)
            continue
        res[batch] = lat
        print(f"int8 batch {batch:6d}: {lat * 1e3:7.3f} ms/frame "
              f"({lat / batch * 1e9:6.1f} ns/stream) [{rt_verdict(lat)}]", flush=True)
        del state, spec
    return res


if __name__ == "__main__":
    main()
