"""Training-step throughput: f32 (the reference recipe) vs bf16 mixed
precision, on one GPU.

Counterpart of the root ``scripts/train_speed.py``.  Times the full train
step of ``train.trainer.make_train_step`` (STFT -> forward -> loss ->
backward -> clip -> Adam -> BatchNorm statistics) over chains of in-place
steps between two synchronizes, host clock less the sync round trip, median
of 3, and prints the audio-throughput multiple, the chain's time between
two CUDA events and the peak device memory of each.

    python -m gtcrn_micro_tpu_torch.scripts.train_speed [--crop_s 8 --batches 16,64]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.utils.profiling import chain_seconds


def measure(step_fn, noisy, clean, *, chain: int = 12, repeats: int = 3,
            rtt: float = 0.0) -> tuple[float, float | None]:
    """(median host seconds per step less ``rtt``, median seconds per step
    between two CUDA events around each chain, None off the card) of
    ``step_fn(noisy, clean) -> loss`` after one warm step."""
    t = chain_seconds(lambda _i: step_fn(noisy, clean), chain, repeats=repeats, rtt=rtt)
    return t.median, t.event


def audio_multiple(batch: int, crop_s: float, step_s: float) -> float:
    """Seconds of audio trained per second of steps."""
    return batch * crop_s / step_s


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="training step rate, f32 and bf16")
    parser.add_argument("--crop_s", type=float, default=8.0)
    parser.add_argument("--batches", default="16,64")
    parser.add_argument("--chain", type=int, default=12, help="steps per timed chain")
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(argv)

    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, init_params
    from gtcrn_micro_tpu_torch.train.trainer import make_optimizer, make_train_step
    from gtcrn_micro_tpu_torch.utils.profiling import measure_rtt

    dev = resolve_device(ns.device)
    on_card = dev.type == "cuda"
    params = init_params(torch.Generator().manual_seed(0), device=dev)
    rtt = measure_rtt(device=dev)
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    print(f"# RTT {rtt * 1e3:.3f} ms; device {name}", flush=True)

    n = int(ns.crop_s * 16000)
    rng = np.random.default_rng(0)
    res = {}
    for b in (int(x) for x in ns.batches.split(",")):
        clean_np = rng.standard_normal((b, n)).astype(np.float32) * 0.05
        noisy_np = clean_np + 0.02 * rng.standard_normal((b, n)).astype(np.float32)
        clean, noisy = (torch.from_numpy(x).to(dev) for x in (clean_np, noisy_np))
        audio_s = b * ns.crop_s
        for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            model = GTCRNMicro.from_params(params, device=dev)  # fresh masters per run
            step = make_train_step(model, make_optimizer(model, device=dev),
                                   compute_dtype=dtype, device=dev)
            if on_card:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t, ev = measure(step, noisy, clean, chain=ns.chain, rtt=rtt)
            peak = torch.cuda.max_memory_allocated() - base if on_card else None
            res[(b, label)] = {"step_s": t, "event_s": ev, "peak_bytes": peak,
                               "audio_x": audio_multiple(b, ns.crop_s, t)}
            extra = (f"; CUDA events {ev * 1e3:.1f} ms/step, peak memory "
                     f"{peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held before"
                     if on_card else "; CUDA events and peak memory not measured (no card)")
            print(f"batch {b:3d} x {ns.crop_s:.0f}s  {label:4s}: "
                  f"{t * 1e3:7.1f} ms/step = {audio_multiple(b, ns.crop_s, t):7.0f}x "
                  f"real-time{extra}", flush=True)
            del model, step
    return res


if __name__ == "__main__":
    main()
