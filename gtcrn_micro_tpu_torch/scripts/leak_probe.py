"""Host-RSS leak probe of the training loop's batch transfer.

Counterpart of the root ``scripts/leak_probe.py``.  A long training run dies
if the trainer's host memory grows with every batch it sends to the device;
``scripts/ref_scale_run.py``'s RSS watchdog assumes it may.  This isolates
the retention by layer:

  --mode putonly   the trainer's transfer of each batch (pinned host memory,
                   a non-blocking copy: ``train.trainer._to_device``), no
                   compute
  --mode compute   the transfer and a trivial reduction of each batch
  --mode full      the port's real training step (``train.trainer.
                   make_train_step``, bf16), which transfers the batch itself
  --mode all       the three in turn

on ``--device`` (default cuda; ``cpu`` is the control, with no transfer).
Each step takes a FRESH host copy of the batch pair, as the loader hands
the loop fresh arrays (``--reuse`` keeps one pair); the losses stay on the
device and are read every 50 steps, as ``train.run`` reads them.  Prints
VmRSS every ``--log-every`` steps with the slope per step since the first
log, and a verdict per mode: LEAK when the slope is above a fifth of the
batch pair's bytes.

    python -m gtcrn_micro_tpu_torch.scripts.leak_probe [--mode all] [--steps 600] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gtcrn_micro_tpu_torch import resolve_device


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def main(argv=None) -> dict:
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, init_params
    from gtcrn_micro_tpu_torch.train.trainer import (
        TrainerConfig,
        _to_device,
        make_optimizer,
        make_train_step,
    )

    ap = argparse.ArgumentParser(description="host RSS per transferred training batch")
    ap.add_argument("--mode", choices=["putonly", "compute", "full", "all"], default="full")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--samples", type=int, default=160000)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--reuse", action="store_true",
                    help="reuse ONE host buffer pair instead of fresh arrays per step")
    ap.add_argument("--device", default=None, help="default cuda; cpu is the control")
    ns = ap.parse_args(argv)
    dev = resolve_device(ns.device)

    batch_mb = ns.batch * ns.samples * 4 * 2 / 1e6
    print(f"# device={dev.type} mode={ns.mode} batch pair = {batch_mb:.1f} MB", flush=True)
    rng = np.random.default_rng(0)
    noisy_h = rng.standard_normal((ns.batch, ns.samples)).astype(np.float32)
    clean_h = rng.standard_normal((ns.batch, ns.samples)).astype(np.float32)

    def run_mode(mode: str) -> float:
        step_fn = None
        if mode == "full":
            model = GTCRNMicro.from_params(init_params(torch.Generator().manual_seed(0),
                                                       device=dev), device=dev)
            step_fn = make_train_step(model, make_optimizer(model, device=dev),
                                      trainer_cfg=TrainerConfig(precision="bf16"),
                                      compute_dtype=torch.bfloat16, device=dev)
        elif mode == "compute":
            def step_fn(n, c):
                return _to_device(n, dev).mean() + _to_device(c, dev).mean()

        pending: list = []
        t0 = time.time()
        r0 = None
        print(f"# [{mode}] step 0 rss={rss_mb():.0f} MB (pre-warm)", flush=True)
        for i in range(1, ns.steps + 1):
            nh, ch = (noisy_h, clean_h) if ns.reuse else (noisy_h.copy(), clean_h.copy())
            if mode == "putonly":
                _to_device(nh, dev), _to_device(ch, dev)
            else:
                pending.append(step_fn(nh, ch))
            if pending and i % 50 == 0:
                float(torch.stack(pending).sum())
                pending.clear()
            if i % ns.log_every == 0 or i == 1:
                r = rss_mb()
                if r0 is None:
                    r0 = r  # the baseline after the first step's set-up
                slope = (r - r0) / max(i - ns.log_every, 1)
                print(f"[{mode}] step {i:5d} rss={r:8.0f} MB  slope={slope:+7.3f} MB/step  "
                      f"t={time.time() - t0:6.0f}s", flush=True)
        if pending:
            float(torch.stack(pending).sum())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        r = rss_mb()
        per_step = (r - r0) / max(ns.steps - ns.log_every, 1)
        verdict = "LEAK" if per_step > 0.2 * batch_mb else "clean"
        print(f"# [{mode}] {verdict}: {per_step:+.3f} MB/step over {ns.steps} steps "
              f"(batch pair {batch_mb:.1f} MB)", flush=True)
        return per_step

    modes = ["putonly", "compute", "full"] if ns.mode == "all" else [ns.mode]
    return {m: run_mode(m) for m in modes}


if __name__ == "__main__":
    main()
