"""Ablation of the GTConv channel interleave on the layered model's step.

Counterpart of the root ``scripts/ablate_shuffle.py``.  Each of the six
GTConv blocks interleaves its two channel halves
(``nn.blocks.GTConvBlock.shuffle``).  The layered bf16 streaming step at
``[batch]`` streams is timed with three forms of it, swapped in through
that seam:

- ``copy``: the port's stack-and-flatten, one copy (shipped);
- ``one-hot``: JAX's two one-hot channel products and a sum (JAX's shipped
  form; exact, 0/1 weights and single-term sums);
- ``concat``: a plain channel concat, numerically wrong but of the same
  shapes: the floor of any fold of the interleave into the pointwise
  weights.

Each form: the median, min and max over 3 chains of ``CHAIN`` steps (host
clock less the sync round trip, ``utils.profiling.chain_seconds``).  The
seam is restored in a ``finally``.

    python -m gtcrn_micro_tpu_torch.scripts.ablate_shuffle [batch] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools

import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.nn import blocks
from gtcrn_micro_tpu_torch.utils.profiling import chain_seconds, measure_rtt

CHAIN = 160


@functools.lru_cache(maxsize=None)
def _scatter(half: int, dtype: torch.dtype, device: torch.device):
    """The (half, 2 half) one-hot matrices: ``eg`` places channel c at 2c,
    ``ep`` at 2c + 1."""
    eye = torch.eye(half, dtype=dtype, device=device)
    zeros = torch.zeros((half, half), dtype=dtype, device=device)
    eg = torch.stack([eye, zeros], dim=-1).reshape(half, 2 * half)
    ep = torch.stack([zeros, eye], dim=-1).reshape(half, 2 * half)
    return eg, ep


def onehot_shuffle(x1, x2):
    """JAX's ``GTConvBlock.shuffle``: two one-hot channel products."""
    eg, ep = _scatter(x1.shape[-1], x1.dtype, x1.device)
    return x1 @ eg + x2 @ ep


def concat_shuffle(x1, x2):
    """Not an interleave: the halves side by side (the fold's floor)."""
    return torch.cat([x1, x2], dim=-1)


def measure(model, batch: int, rtt: float) -> tuple[float, float, float]:
    """(median, min, max) seconds per one-hop step at ``batch`` streams."""
    state = model.init_state(batch)
    spec = torch.zeros((batch, model.config.n_freqs, 1, 2), dtype=model.dtype,
                       device=model.device)
    t = chain_seconds(lambda _i: model.step(None, state, spec)[0], CHAIN, rtt=rtt, warm=5)
    return t.median, t.min, t.max


def main(argv=None) -> dict:
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, init_params

    parser = argparse.ArgumentParser(description="the GTConv interleave: copy, one-hot, concat")
    parser.add_argument("batch", nargs="?", type=int, default=8192)
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(argv)
    dev = resolve_device(ns.device)
    model = GTCRNMicro.from_params(init_params(torch.Generator().manual_seed(0), device=dev),
                                   dtype=torch.bfloat16, device=dev)
    rtt = measure_rtt(device=dev)
    print(f"# sync RTT {rtt * 1e3:.3f} ms, batch {ns.batch}, layered bf16 on {dev.type}",
          flush=True)
    res = {}
    shipped = blocks.GTConvBlock.shuffle
    try:
        for name, label, form in (("copy", "stack+flatten copy (shipped):", shipped),
                                  ("one-hot", "two one-hot products (JAX):  ", onehot_shuffle),
                                  ("concat", "plain concat (fold's floor): ", concat_shuffle)):
            blocks.GTConvBlock.shuffle = staticmethod(form)
            res[name] = med, lo, hi = measure(model, ns.batch, rtt)
            print(f"{label} {med * 1e3:.3f} ms/step [{lo * 1e3:.3f},{hi * 1e3:.3f}]", flush=True)
    finally:
        blocks.GTConvBlock.shuffle = staticmethod(shipped)
    real = res["copy"][0]
    print(f"fold upper bound: {(real - res['concat'][0]) / real * 100:+.1f}% of the step; "
          f"one-hot products delta: {(real - res['one-hot'][0]) / real * 100:+.1f}%", flush=True)
    return res


if __name__ == "__main__":
    main()
