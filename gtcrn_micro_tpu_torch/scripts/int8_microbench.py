"""Micro-benchmark: is an int8 pointwise chain faster than bf16 on the card?

Counterpart of the root ``scripts/int8_microbench.py``: the premise check of
the int8 serving path.  The int8 step is bound by its intermediate
activations' round trips through memory; int8 storage halves those bytes if
the requantize (scale, bias, PReLU, round and clip) costs less than it
saves.  Three chains of ``n_layers`` pointwise layers (B, 33, 16) @ (16, 16),
the model's dominant boundary shape, from ``np.random.default_rng(0)``:

- ``bf16``: x -> bf16 product with a float32 accumulator -> bias, PReLU 0.1
  -> bf16;
- ``int8``: q -> int8 product to int32 (``torch._int_mm`` on (B*33, 16) x
  (16, 16) on the card, ``ops/int8_step.int_matmul``) -> scale 0.01, bias,
  PReLU 0.1, requantized by round and clip -> int8;
- ``int8-noreq``: the int8 product on the first layer only, then bf16 as
  above (no requantize; isolates its cost).

Each chain is eager PyTorch, one kernel per operation.  Prints ms per chain
and ns per stream-layer (host clock over 50 chains less the sync round trip,
``utils.profiling.chain_seconds``).  A chain that runs out of device memory
prints ``FAIL OOM``; any other error propagates.

    python -m gtcrn_micro_tpu_torch.scripts.int8_microbench [batch] [n_layers] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.ops.int8_step import int_matmul
from gtcrn_micro_tpu_torch.utils.profiling import chain_seconds, measure_rtt

F, C = 33, 16
REPS = 50


def make_inputs(batch: int, n_layers: int, device=None) -> dict:
    """The root script's tensors, from ``np.random.default_rng(0)`` in its
    order: int8 weights ``w8``, their bf16 copies ``wb`` (x 0.01), float32
    ``bias``, bf16 activations ``xb`` and int8 activations ``xq``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    w8 = torch.from_numpy(rng.integers(-127, 128, (n_layers, C, C)).astype(np.int8))
    wb = w8.to(torch.bfloat16) * torch.tensor(0.01, dtype=torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal((n_layers, C)).astype(np.float32))
    xb = torch.from_numpy(rng.standard_normal((batch, F, C)).astype(np.float32)).to(torch.bfloat16)
    xq = torch.from_numpy(rng.integers(-127, 128, (batch, F, C)).astype(np.int8))
    return {k: v.to(dev) for k, v in dict(w8=w8, wb=wb, bias=bias, xb=xb, xq=xq).items()}


def _has_mm_out_dtype(dev: torch.device) -> bool:
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::mm.dtype", "CUDA" if dev.type == "cuda" else "CPU")


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 (B, F, K) x bf16 (K, N) -> float32 (B, F, N): one bf16 product
    with a float32 accumulator and output (``mm(out_dtype=float32)``), or
    where the backend has none (the CPU) the float32 product of the same
    exact bf16 values."""
    B = x.shape[0]
    x2 = x.reshape(B * F, -1)
    if _has_mm_out_dtype(x.device):
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float()
    return y.reshape(B, F, -1)


def int8_dot(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 (B, F, K) x int8 (K, N) -> int32 (B, F, N), as one 2-D product."""
    B = q.shape[0]
    return int_matmul(q.reshape(B * F, -1), w).reshape(B, F, -1)


def chain_bf16(x, wb, bias):
    for i in range(len(wb)):
        y = dot_f32(x, wb[i])
        y = y + bias[i]
        x = torch.maximum(y, 0.1 * y).to(torch.bfloat16)
    return x


def requant(y, bias_i):
    """Scale, bias, PReLU, then round and clip back to int8 (the epilogue)."""
    v = y.to(torch.float32) * 0.01 + bias_i
    v = torch.maximum(v, 0.1 * v)
    return torch.clamp(torch.round(v * 12.7), -128, 127).to(torch.int8)


def chain_int8(q, w8, bias):
    for i in range(len(w8)):
        q = requant(int8_dot(q, w8[i]), bias[i])
    return q


def chain_int8_noreq(q, w8, wb, bias):
    x = None
    for i in range(len(w8)):
        acc = int8_dot(q, w8[i]) if x is None else dot_f32(x, wb[i])
        y = acc.to(torch.float32) + bias[i]
        x = torch.maximum(y, 0.1 * y).to(torch.bfloat16)
    return x


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="bf16 vs int8 pointwise chains")
    parser.add_argument("batch", nargs="?", type=int, default=16384)
    parser.add_argument("n_layers", nargs="?", type=int, default=40)
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(argv)
    dev = resolve_device(ns.device)
    t = make_inputs(ns.batch, ns.n_layers, dev)
    rtt = measure_rtt(device=dev)
    mm = ("mm(out_dtype=float32)" if _has_mm_out_dtype(dev)
          else "float32 product of the bf16 values")
    print(f"# batch {ns.batch}, {ns.n_layers} layers, sync RTT {rtt * 1e3:.3f} ms; bf16 products "
          f"by {mm}; {dev.type}", flush=True)
    res = {}
    for name, fn in (("bf16", lambda: chain_bf16(t["xb"], t["wb"], t["bias"])),
                     ("int8", lambda: chain_int8(t["xq"], t["w8"], t["bias"])),
                     ("int8-noreq", lambda: chain_int8_noreq(t["xq"], t["w8"], t["wb"],
                                                             t["bias"]))):
        try:
            dt = chain_seconds(lambda _i: fn(), REPS, repeats=1, rtt=rtt).median
        except torch.cuda.OutOfMemoryError:
            res[name] = None
        else:
            res[name] = dt
        if res[name] is None:
            torch.cuda.empty_cache()
            print(f"{name}: FAIL OOM", flush=True)
            continue
        per = dt / ns.n_layers / ns.batch * 1e9
        print(f"{name:12s}: {dt * 1e3:7.3f} ms/chain  {per:6.2f} ns/stream-layer", flush=True)
    return res


if __name__ == "__main__":
    main()
