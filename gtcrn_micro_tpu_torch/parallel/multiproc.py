"""Data-parallel training across real processes, held against one process.

Counterpart of the JAX package's ``scripts/multiproc_dp.py``:

    python -m gtcrn_micro_tpu_torch.parallel.multiproc [--nproc 2] [--device cpu]

Each of ``nproc`` spawned ranks (gloo on the CPU, NCCL on ``cuda:rank``)
joins the group through ``parallel.mesh.init_distributed`` and takes one
f32 step of ``train.trainer.make_train_step(group=...)`` on its rows of the
JAX script's global batch (4 x 4,096 samples of seeded white noise, seed 7;
warmup 5, decay until 100, max lr 1e-3) from ``init_params`` (seed 0).  The
parent takes the same step on the whole batch in one process and compares:
the loss at rtol 1e-5; every leaf of the params tree at atol 2e-5 (under
the warmup the first update has a learning rate of 0, so the BatchNorm
running statistics are what moves); and every averaged gradient within
1e-4 of the largest gradient, the bound ``chip_smoke.py`` holds the card's
gradients to (float32 itself is good to ~1e-5 of it: a gradient that
cancels carries the rounding of its large terms).  ``--local-bn-stats`` is
the canary: each rank steps on its rows without the group, so its
BatchNorms normalise with its own batch statistics, as plain DDP would
(DDP's gradient average does not reach the running statistics), and those
must then fail the comparison.  Exit 0 iff the ranks agree with each other
and with the one process.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import tempfile

import numpy as np
import torch

SEED = 7
GLOBAL_BATCH = 4
N_SAMPLES = 4096
LOSS_RTOL, PARAM_ATOL, GRAD_OF_MAX = 1e-5, 2e-5, 1e-4


def make_batch() -> tuple[np.ndarray, np.ndarray]:
    """The JAX script's first global batch (noisy, clean)."""
    rng = np.random.default_rng(SEED)
    clean = rng.standard_normal((GLOBAL_BATCH, N_SAMPLES)).astype(np.float32) * 0.05
    noise = rng.standard_normal((GLOBAL_BATCH, N_SAMPLES)).astype(np.float32) * 0.02
    return clean + noise, clean


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_step(device, group=None, rank: int = 0, world: int = 1) -> dict:
    """One f32 step on this rank's rows: ``{"loss", "params", "grads"}`` on
    the CPU (params by dotted name, the BatchNorm running statistics
    included)."""
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, init_params
    from gtcrn_micro_tpu_torch.parallel.mesh import shard_batch_multiprocess
    from gtcrn_micro_tpu_torch.train.scheduler import WarmupCosineConfig
    from gtcrn_micro_tpu_torch.train.trainer import make_optimizer, make_train_step

    sched = WarmupCosineConfig(warmup_steps=5, decay_until_step=100, max_lr=1e-3)
    model = GTCRNMicro.from_params(init_params(torch.Generator().manual_seed(0), device=device),
                                   device=device)
    opt = make_optimizer(model, sched, device=device)
    step = make_train_step(model, opt, device=device, group=group)
    noisy, clean = shard_batch_multiprocess(make_batch(), rank, world)
    loss = float(step(noisy, clean))
    return {"loss": loss,
            "params": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            "grads": {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}}


def _worker(rank: int, world: int, port: int, device: str, out_dir: str,
            local_bn: bool) -> None:
    """One rank (the target of ``torch.multiprocessing``'s spawn)."""
    import torch.distributed as dist

    from gtcrn_micro_tpu_torch.parallel.mesh import init_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if device == "cpu":
        torch.set_num_threads(2)
    rank, world, dev, group = init_distributed(device)
    try:  # the canary steps without the group: per-rank BatchNorm statistics
        torch.save(train_step(dev, None if local_bn else group, rank, world),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(nproc: int, device: str = "cpu", local_bn: bool = False) -> list[dict]:
    """Spawn ``nproc`` ranks, each taking one step; their results."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_worker, args=(nproc, free_port(), device, d, local_bn),
                           nprocs=nproc, join=True, start_method="spawn")
        return [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(nproc)]


def compare(ranks: list[dict], single: dict) -> dict:
    """The ranks' worst disagreement with one process, each over its
    bound: ``{"loss", "params", "grads", "ranks"}`` (each ok when <= 1;
    ``ranks`` is 0 when every rank holds the same params)."""
    g_max = max(float(g.abs().max()) for g in single["grads"].values())
    out = {"loss": 0.0, "params": 0.0, "grads": 0.0, "ranks": 0.0}
    for r in ranks:
        out["loss"] = max(out["loss"], abs(r["loss"] / single["loss"] - 1) / LOSS_RTOL)
        out["params"] = max(out["params"], max(
            float((r["params"][k] - v).abs().max()) for k, v in single["params"].items())
            / PARAM_ATOL)
        out["grads"] = max(out["grads"], max(
            float((r["grads"][k] - v).abs().max()) for k, v in single["grads"].items())
            / (GRAD_OF_MAX * g_max))
        out["ranks"] = max(out["ranks"], max(
            float((r["params"][k] - v).abs().max()) for k, v in ranks[0]["params"].items()))
    return out


def main(args=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    parser.add_argument("--local-bn-stats", action="store_true",
                        help="the canary: per-rank BatchNorm statistics (must fail)")
    ns = parser.parse_args(args)
    from gtcrn_micro_tpu_torch import resolve_device

    dev = resolve_device(ns.device)
    ranks = run_ranks(ns.nproc, dev.type, ns.local_bn_stats)
    errs = compare(ranks, train_step(dev))
    ok = all(errs[k] <= 1 for k in ("loss", "params", "grads")) and errs["ranks"] == 0
    print(f"{ns.nproc} ranks vs one process on {dev.type}: worst over bound loss "
          f"{errs['loss']:.3g}, params {errs['params']:.3g}, grads {errs['grads']:.3g}; ranks "
          f"agree {errs['ranks'] == 0}: {'OK' if ok else 'MISMATCH'}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
