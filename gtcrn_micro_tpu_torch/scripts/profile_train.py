"""Trace the training step on one GPU and break down its device time.

Counterpart of the root ``scripts/profile_train.py``: the same method as
``profile_serving`` (a ``torch.profiler`` trace -> device time by kernel
category, idle share, top operations), applied to the full train step of
``train.trainer.make_train_step`` (STFT -> forward -> loss incl. iSTFT x2 ->
backward -> clip -> Adam -> BatchNorm statistics), bf16 by default.

    python -m gtcrn_micro_tpu_torch.scripts.profile_train [batch] [--crop_s 8] [--f32]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.scripts.profile_serving import breakdown
from gtcrn_micro_tpu_torch.utils.profiling import chain_seconds, device_events, measure_rtt

CHAIN = 12  # steps timed
TRACED_STEPS = 8  # steps traced


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="device-time breakdown of the training step")
    parser.add_argument("batch", type=int, nargs="?", default=64)
    parser.add_argument("--crop_s", type=float, default=8.0)
    parser.add_argument("--f32", action="store_true", help="the f32 recipe instead of bf16")
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(argv)

    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, init_params
    from gtcrn_micro_tpu_torch.train.trainer import make_optimizer, make_train_step

    dev = resolve_device(ns.device)
    dtype = None if ns.f32 else torch.bfloat16
    model = GTCRNMicro.from_params(init_params(torch.Generator().manual_seed(0), device=dev),
                                   device=dev)
    step = make_train_step(model, make_optimizer(model, device=dev), compute_dtype=dtype,
                           device=dev)

    n = int(ns.crop_s * 16000)
    rng = np.random.default_rng(0)
    clean_np = rng.standard_normal((ns.batch, n)).astype(np.float32) * 0.05
    noisy_np = clean_np + 0.02 * rng.standard_normal((ns.batch, n)).astype(np.float32)
    clean, noisy = (torch.from_numpy(x).to(dev) for x in (clean_np, noisy_np))

    rtt = measure_rtt(device=dev)
    lat = chain_seconds(lambda _i: step(noisy, clean), CHAIN, repeats=1, rtt=rtt).median
    name = "f32" if dtype is None else "bf16"
    print(f"train step batch {ns.batch} x {ns.crop_s:.0f}s {name}: "
          f"{lat * 1e3:.1f} ms/step", flush=True)
    res = {"step_s": lat}
    if dev.type != "cuda":
        print("device breakdown not measured: no card", flush=True)
        return res
    evs, wall_us = device_events(lambda i: step(noisy, clean), TRACED_STEPS)
    res.update(breakdown(evs, wall_us, TRACED_STEPS))
    return res


if __name__ == "__main__":
    main()
