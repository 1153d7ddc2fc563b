"""Chunk size x batch sweep of the layered model's streaming step, on one GPU.

Counterpart of the root ``scripts/sweep_chunk.py``.  For each (T, batch):
the layered model (``models.gtcrn_micro.GTCRNMicro``, bf16 weights, state
and activations) steps ring state T hops at a time; the cell is the median,
min and max over 3 chains, each chain streaming ``CHAIN_FRAMES`` frames per
stream (at least ``MIN_STEPS`` steps), as ms per FRAME (= step time / T).
Host clock around chains that end in a synchronize, less the sync round
trip (``utils.profiling.chain_seconds``).  A cell that runs out of device
memory prints ``FAIL OOM``; any other error stops the sweep.

    python -m gtcrn_micro_tpu_torch.scripts.sweep_chunk [--fast] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.utils.profiling import chain_seconds, measure_rtt

CHAIN_FRAMES = 192  # frames of audio each chain streams (per cell)
MIN_STEPS = 24      # steps of the shortest chain
CHUNKS = (1, 2, 4, 8)
BATCHES = (8192, 16384, 32768, 40960, 49152, 65536)
FAST_BATCHES = (16384, 32768, 40960)


def state_bytes(model, batch: int, dtype=torch.bfloat16) -> int:
    """Bytes of the ring state of ``batch`` streams (from ``init_state``)."""
    st = model.init_state(1, dtype=dtype)
    return batch * sum(v.numel() * v.element_size() for k, v in st.items() if k != "step")


def chain_latency(model, batch: int, chunk: int, rtt: float,
                  repeats: int = 3) -> tuple[float, float, float]:
    """(median, min, max) seconds per FRAME over ``repeats`` chains."""
    steps = max(CHAIN_FRAMES // chunk, MIN_STEPS)
    state = model.init_state(batch, dtype=torch.bfloat16)
    spec = torch.zeros((batch, model.config.n_freqs, chunk, 2), dtype=torch.bfloat16,
                       device=model.device)

    def step(_i):
        return model.step(state, spec)[0]  # the state updates in place

    t = chain_seconds(step, steps, repeats=repeats, rtt=rtt, warm=5)
    return t.median / chunk, t.min / chunk, t.max / chunk


def main(argv=None) -> dict:
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, init_params

    parser = argparse.ArgumentParser(description="ms per frame of the layered step, T x batch")
    parser.add_argument("--fast", action="store_true", help=f"batches {FAST_BATCHES} only")
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(argv)
    dev = resolve_device(ns.device)
    model = GTCRNMicro.from_params(init_params(torch.Generator().manual_seed(0), device=dev),
                                   dtype=torch.bfloat16, device=dev)
    rtt = measure_rtt(device=dev)
    batches = FAST_BATCHES if ns.fast else BATCHES
    print(f"# sync RTT {rtt * 1e3:.3f} ms; median of 3 chains, {CHAIN_FRAMES} frames/chain "
          f"(>= {MIN_STEPS} steps); layered bf16 on {dev.type}", flush=True)
    print("# ring state: " + ", ".join(f"{b}: {state_bytes(model, b) / 2**30:.2f} GiB"
                                       for b in batches), flush=True)
    print(f"# {'batch':>7} " + " ".join(f"T={t:<2d} ms/frame (spread)".rjust(26)
                                        for t in CHUNKS), flush=True)
    cells = {}
    for b in batches:
        row = [f"{b:9d}"]
        for t in CHUNKS:
            try:
                cells[(b, t)] = chain_latency(model, b, t, rtt)
            except torch.cuda.OutOfMemoryError:
                cells[(b, t)] = None
            if cells[(b, t)] is None:  # the failed cell's tensors are released by now
                torch.cuda.empty_cache()
                row.append("FAIL OOM".rjust(26))
                continue
            med, lo, hi = cells[(b, t)]
            row.append(f"{med * 1e3:8.3f} [{lo * 1e3:7.3f},{hi * 1e3:7.3f}]")
        print(" ".join(row), flush=True)
    return cells


if __name__ == "__main__":
    main()
