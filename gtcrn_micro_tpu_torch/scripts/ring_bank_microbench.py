"""Micro-benchmark: separate small rings against one stacked ring bank.

Counterpart of the root ``scripts/ring_bank_microbench.py``.  It reproduces
the serving step's L == 2 ring pattern in isolation: per ring, a depthwise
(1, 3) conv of the input and of each of the two taps read at ``(t + j) % 2``,
summed, and the input written in place at slot ``t % 2``; 8 rings in a row,
bf16, in two state layouts:

- ``separate``: 8 rings of (B, 2, 33, 16), the layered model's layout;
- ``bank``: one (8, B, 2, 33, 16) tensor, indexed by ring and slot.

Each layout's step is timed over 3 chains of ``CHAIN`` steps (host clock
less the sync round trip, ``utils.profiling.chain_seconds``).  The root
script counts the copies XLA put in the compiled step's HLO; eager PyTorch
has none, so in its place this counts, in a ``utils.profiling.trace`` of
one step, the ``aten::copy_`` operations and the device's copy-class
operations (``Memcpy`` and the kernels that
``scripts/profile_serving.categorize`` calls copies).

    python -m gtcrn_micro_tpu_torch.scripts.ring_bank_microbench [batch] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile

import torch
import torch.nn.functional as tF

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.scripts.profile_serving import categorize
from gtcrn_micro_tpu_torch.utils.profiling import chain_seconds, measure_rtt, trace

N_RINGS = 8
L = 2
F, C = 33, 16
CHAIN = 200


def conv_weights(device) -> list[torch.Tensor]:
    """N_RINGS depthwise (1, 3) kernels (C, 1, 1, 3), bf16, scale 0.1."""
    g = torch.Generator().manual_seed(0)
    return [(torch.randn((C, 1, 1, 3), generator=g) * 0.1).to(device, torch.bfloat16)
            for _ in range(N_RINGS)]


def dwconv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise (1, 3) conv along F, zero-padded: x (B, 1, F, C) -> (B, 1, F, C)
    (the channel-last layout, as a view)."""
    y = tF.conv2d(x.permute(0, 3, 1, 2), w, padding=(0, 1), groups=C)
    return y.permute(0, 2, 3, 1)


def sep_step(ws, state: dict, x: torch.Tensor) -> torch.Tensor:
    """state: N_RINGS rings ``r<i>`` (B, L, F, C) and ``step``; x (B, 1, F, C)."""
    t = state["step"]
    h = x
    for i in range(N_RINGS):
        ring = state[f"r{i}"]
        out = dwconv(h, ws[i])
        for j in range(2):
            slot = (t + j) % L
            out = out + dwconv(ring[:, slot:slot + 1], ws[i])
        ring[:, t % L] = h[:, 0]
        h = out
    state["step"] = (t + 1) & 15
    return h


def bank_step(ws, state: dict, x: torch.Tensor) -> torch.Tensor:
    """state: ``bank`` (N_RINGS, B, L, F, C) and ``step``; x (B, 1, F, C)."""
    t = state["step"]
    bank = state["bank"]
    h = x
    for i in range(N_RINGS):
        out = dwconv(h, ws[i])
        for j in range(2):
            slot = (t + j) % L
            out = out + dwconv(bank[i, :, slot:slot + 1], ws[i])
        bank[i, :, t % L] = h[:, 0]
        h = out
    state["step"] = (t + 1) & 15
    return h


def copy_counts(step, ws, state: dict, x: torch.Tensor) -> tuple[int, int]:
    """(``aten::copy_`` operations, device copy-class operations) in a trace
    of one ``step``."""
    with tempfile.TemporaryDirectory() as d:
        with trace(d) as path:
            out = step(ws, state, x)
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    host = sum(e.get("cat") == "cpu_op" and e.get("name") == "aten::copy_" for e in events)
    device = sum(e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and categorize(e.get("name", "")) == "copy" for e in events)
    return host, device


def run(name: str, step, state: dict, ws, x, rtt: float) -> dict:
    t = chain_seconds(lambda _i: step(ws, state, x), CHAIN, repeats=3, rtt=rtt, warm=5)
    host, device = copy_counts(step, ws, state, x)
    print(f"{name:9s}: {t.median * 1e3:7.3f} ms/step  [{t.min * 1e3:.3f},{t.max * 1e3:.3f}]  "
          f"aten::copy_={host} device copies={device}", flush=True)
    return {"median_s": t.median, "min_s": t.min, "max_s": t.max, "copy_ops": host,
            "device_copies": device}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="separate rings vs one ring bank")
    parser.add_argument("batch", nargs="?", type=int, default=8192)
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(argv)
    dev = resolve_device(ns.device)
    ws = conv_weights(dev)
    x = torch.zeros((ns.batch, 1, F, C), dtype=torch.bfloat16, device=dev)
    rtt = measure_rtt(device=dev)
    print(f"# sync RTT {rtt * 1e3:.3f} ms, batch {ns.batch}, {N_RINGS} rings of L={L}, bf16 on "
          f"{dev.type}", flush=True)
    sep = {f"r{i}": torch.zeros((ns.batch, L, F, C), dtype=torch.bfloat16, device=dev)
           for i in range(N_RINGS)}
    sep["step"] = 0
    res = {"separate": run("separate", sep_step, sep, ws, x, rtt)}
    del sep
    bank = {"bank": torch.zeros((N_RINGS, ns.batch, L, F, C), dtype=torch.bfloat16, device=dev),
            "step": 0}
    res["bank"] = run("bank", bank_step, bank, ws, x, rtt)
    return res


if __name__ == "__main__":
    main()
