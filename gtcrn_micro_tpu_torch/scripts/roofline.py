"""Roofline of the headline serving step on one GPU: how far from the
card's speed of light?

Counterpart of the root ``scripts/roofline.py``.  Measured with the bench
methodology (chains between two synchronizes, host clock less the sync
round trip, median of 3):

1. **Achievable memory bandwidth** of this card: ``y = x + 1`` over a
   1 GiB bf16 tensor moves 2N bytes per step (read + write) with negligible
   compute -- the practical ceiling of any bandwidth-bound step.
2. **Measured headline step** (audio in -> audio out at ``--batch`` bf16
   streams on ``--backend``, ``bench.measure_step_latency``) -> implied
   memory bytes per stream at that bandwidth.
3. **Accounted traffic floors** from the model structure itself (the JAX
   script's, to the byte):
   - *ideal single-kernel SOL*: per stream per step, an oracle kernel reads
     2 tap frames + writes 1 frame per temporal ring (every temporal conv
     in the family has kT=3), r/w the O(1) DSP carry, and streams the audio
     hop in/out; weights amortise over the batch.
   - *whole-state r+w*: a naive fused kernel that touches every ring slot.
4. **The bound** of the fused forward (``utils/roofline.py``: its bytes at
   the memory peak; its multiply-adds at the peaks of the units that do
   them, the tensor-core mixes as three TF32 products, the rest at the
   float32 peak).  On the H100 kernels B1 and B2 are bound by bytes, so
   this is the floor the served step is held to.

    python -m gtcrn_micro_tpu_torch.scripts.roofline [--batch 8192] [--bw_gb GB/s]
"""

from __future__ import annotations

import argparse
import math

import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.serve import BACKENDS, make_backend
from gtcrn_micro_tpu_torch.utils.profiling import chain_seconds, measure_rtt


def measure_bw(nbytes: int = 1 << 30, chain: int = 30, repeats: int = 3,
               rtt: float = 0.0, device=None) -> float:
    """Sustained memory GB/s of a bf16 ``x + 1`` (2N bytes per step)."""
    dev = resolve_device(device)
    x = [torch.zeros((nbytes // 2,), dtype=torch.bfloat16, device=dev)]

    def add(_i):
        x[0] = x[0] + 1.0
        return x[0]

    return 2.0 * nbytes / chain_seconds(add, chain, repeats=repeats, rtt=rtt).median / 1e9


def accounted_floors(model, batch: int) -> dict[str, float]:
    """Per-stream bytes/step floors derived from the layered model's own
    ring state (``models.gtcrn_micro.GTCRNMicro``).

    Every temporal ring has shape (B, L, ...) with frame size
    prod(shape[2:]); kT == 3 for every temporal conv in this family, so an
    ideal kernel reads 2 tap frames and writes 1 frame per ring per step.
    """
    state = model.init_state(1, dtype=torch.bfloat16, ring=True)
    ideal = 0  # elements
    whole = 0
    for leaf in state.values():
        if not torch.is_tensor(leaf) or leaf.dim() < 2:  # step counter
            continue
        frame = math.prod(leaf.shape[2:])
        ideal += 3 * frame          # 2 tap reads + 1 write
        whole += 2 * leaf.numel()   # read + write every slot
    hop = model.config.hop_len
    dsp = 2 * (2 * hop)             # in_buf + ola_buf, read + write
    io = 2 * hop                    # audio hop in + out
    params = sum(v.numel() for v in model.state_dict().values())
    bytes_per = 2  # bf16 serving config
    return {
        "ideal_per_stream": (ideal + dsp + io) * bytes_per
        + params * bytes_per / batch,
        "whole_state_per_stream": (whole + dsp + io) * bytes_per
        + params * bytes_per / batch,
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="memory and operation roofline of the served step")
    parser.add_argument("--batch", type=int, default=8192)
    parser.add_argument("--bw_gb", type=float, default=0.0,
                        help="skip the bandwidth microbench and use this GB/s")
    parser.add_argument("--backend", choices=BACKENDS, default="grid")
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(argv)

    from gtcrn_micro_tpu_torch.bench import measure_step_latency
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, init_params
    from gtcrn_micro_tpu_torch.ops.fused_step import LayoutGTCRNMicro, kernel_weights, unpack
    from gtcrn_micro_tpu_torch.utils.roofline import (
        H100_F32_FLOPS,
        H100_HBM_BYTES,
        H100_TF32_FLOPS,
        fused_step_bound,
    )

    dev = resolve_device(ns.device)
    params = init_params(torch.Generator().manual_seed(0), device=dev)
    model = make_backend(ns.backend, params, torch.bfloat16, dev)
    rtt = measure_rtt(device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# RTT {rtt * 1e3:.3f} ms; device {name}; backend {ns.backend}", flush=True)

    bw = ns.bw_gb or measure_bw(rtt=rtt, device=dev)
    print(f"achievable memory bandwidth (bf16 x+1 triad): {bw:.0f} GB/s", flush=True)

    med, lo, hi = measure_step_latency(model, params, ns.batch, rtt=rtt)
    per_stream_us = med / ns.batch * 1e6
    implied = per_stream_us * 1e-6 * bw * 1e9
    print(f"headline audio step @ {ns.batch}: {med * 1e3:.3f} ms "
          f"[{lo * 1e3:.3f},{hi * 1e3:.3f}] = {per_stream_us:.4f} us/stream",
          flush=True)
    print(f"implied memory traffic at {bw:.0f} GB/s: "
          f"{implied / 1024:.1f} KB/stream/step", flush=True)

    floors = accounted_floors(GTCRNMicro(device=dev), ns.batch)
    ideal = floors["ideal_per_stream"]
    whole = floors["whole_state_per_stream"]
    print(f"ideal single-kernel SOL:  {ideal / 1024:.1f} KB/stream/step "
          f"-> {ideal / bw / 1e9 * 1e6:.4f} us/stream", flush=True)
    print(f"whole-state r+w bound:    {whole / 1024:.1f} KB/stream/step "
          f"-> {whole / bw / 1e9 * 1e6:.4f} us/stream", flush=True)
    print(f"step vs ideal SOL: {implied / ideal:.2f}x; "
          f"vs whole-state bound: {implied / whole:.2f}x", flush=True)

    plain = LayoutGTCRNMicro(params, dtype=torch.float32, device=dev)
    kw_floats = kernel_weights(plain.weights).buf.numel()
    op_ms, by, flops, nbytes = fused_step_bound(unpack(plain.weights), ns.batch, 2, kw_floats)
    print(f"fused forward bound @ {ns.batch}: {flops / 1e9:.3f} GFLOP f32, "
          f"{nbytes / 1e6:.1f} MB -> {op_ms:.4f} ms by {by} (H100 SXM peaks, "
          f"{H100_F32_FLOPS / 1e12:.0f} TFLOP/s f32, {H100_TF32_FLOPS / 1e12:.1f} TFLOP/s "
          f"TF32, {H100_HBM_BYTES / 1e12:.2f} TB/s); step is {med * 1e3 / op_ms:.1f}x it",
          flush=True)
    return {"bw_gb": bw, "step_s": med, "floors": floors, "op_bound_ms": op_ms,
            "bound_by": by, "launches": getattr(model, "launches", None)}


if __name__ == "__main__":
    main()
