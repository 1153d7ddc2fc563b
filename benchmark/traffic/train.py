"""The DNS3 recipe's training loop: batches of ``batch`` x ``crop_s`` crops
from ``PairedWavDataset`` + ``PrefetchLoader`` (the recipe's loader, over a
seeded pool of wav pairs in the DNS3 ``fileid_`` layout) into the step of
``make_train_step`` (STFT, training forward, hybrid loss, backward, clip,
Adam at the warmup-cosine rate, BatchNorm running statistics), as
``train.run`` drives it: the losses stay on the device and are read every
``log_every`` steps.  The optimizer resumes at update ``start_step``, so
every step moves the weights at the schedule's rate there.

Set-up builds the one model, optimizer and step, and drives them through
their first three steps on the loader's first three batches: the check
compares each step's loss, the first step's clipped gradient (from the Adam
moment after one step), every trained leaf's change over the three steps and
the BatchNorm running statistics' change over the first with the plain
reference fed the same wavs.  The window then goes on with the same
objects and the same feed.

``train_audio_x`` = seconds of audio trained / seconds of the window.
"""

from __future__ import annotations

import contextlib
import shutil
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.harness import (
    Check,
    Outcome,
    leaf_gaps,
    memory_peak,
    rel_gap,
    worst,
    worst_leaf_gap,
)
from benchmark.reference import gtcrn
from benchmark.reference import train as ref_train
from benchmark.trace import Trace, traced

CHECK_STEPS = 3


class _Feed:
    """The recipe's loader, epoch after epoch."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        while True:
            self.loader.dataset.sample_data_per_epoch()
            yield from self.loader


def _snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run(ctx) -> Outcome:
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro
    from gtcrn_micro_tpu_torch.train.dataloader import PairedWavDataset, PrefetchLoader
    from gtcrn_micro_tpu_torch.train.loss import HybridLossConfig
    from gtcrn_micro_tpu_torch.train.scheduler import WarmupCosineConfig
    from gtcrn_micro_tpu_torch.train.trainer import (
        B1,
        TrainerConfig,
        make_optimizer,
        make_train_step,
    )

    cell, cfg, dev = ctx.cell, ctx.config, ctx.device
    root, noisy_pcm, clean_pcm = inputs.dns3_pairs(cell["pairs"], cell["crop_s"], ctx.seed, dev)
    try:
        P = gtcrn.init_params(inputs.seed_of(ctx.seed, "weights"), dev)
        model = GTCRNMicro.from_params(gtcrn.nest(P), device=dev)
        rec = cfg["recipe"]
        opt = make_optimizer(model, WarmupCosineConfig(**rec["scheduler"]), rec["clip_grad_norm"],
                             device=dev)
        opt.count = cell["start_step"]
        step = make_train_step(model, opt, HybridLossConfig(**rec["loss"]),
                               TrainerConfig(precision=cfg["precision_name"]), device=dev)
        ds = PairedWavDataset(noisy_root=f"{root}/noisy", fs=inputs.FS,
                              length_seconds=cell["crop_s"], total_train_data=cell["pairs"],
                              num_data_per_epoch=rec["num_data_per_epoch"], random_start=False,
                              train=True, seed=inputs.seed_of(ctx.seed, "dataset") % (1 << 32))
        loader = PrefetchLoader(ds, batch_size=cell["batch"], num_workers=cell["num_workers"],
                                drop_last=True, seed=inputs.seed_of(ctx.seed, "order") % (1 << 32))
        feed = iter(_Feed(loader))

        fed, losses, grad1 = [], [], None
        for i in range(CHECK_STEPS):
            noisy, clean = next(feed)
            fed.append(noisy)
            losses.append(float(step(noisy, clean)))
            if i == 0:
                grad1 = {n: m.detach() / (1 - B1) for n, m in zip(opt.names, opt.mu)}
                stats1 = {k: v.detach().clone() for k, v in model.named_buffers()
                          if ".running_" in k}
        after = _snapshot(model)
        setup_s = ctx.setup_s()

        span = [contextlib.nullcontext]
        log_every = rec["log_every"]

        waits: list = []  # host seconds waiting for each batch

        def loop(seconds: float) -> tuple[int, float, list]:
            pending, logged, n = [], [], 0
            t0 = time.perf_counter()
            while True:
                t_wait = time.perf_counter()
                with span[0]("loader.next"):
                    noisy, clean = next(feed)
                waits.append(time.perf_counter() - t_wait)
                with span[0]("train.step"):
                    pending.append(step(noisy, clean))
                n += 1
                if n % log_every == 0:
                    logged.append(float(torch.stack(pending).sum()))
                    pending.clear()
                if time.perf_counter() - t0 >= seconds:
                    break
            if pending:
                logged.append(float(torch.stack(pending).sum()))
            ctx.sync()
            return n, time.perf_counter() - t0, logged

        steps, window_s, logged = loop(ctx.seconds)
        window_waits = list(waits)
        audio_s = steps * cell["batch"] * cell["crop_s"]
        ctx.log(f"{steps} training steps of {cell['batch']} x {cell['crop_s']} s in "
                f"{window_s:.4f} s")
        trace = None
        if ctx.trace:
            from torch.profiler import record_function

            trace = Trace(cfg, cell)
            span[0] = record_function
            with traced(trace, ("loader.next", "train.step")):
                n, _, _ = loop(cell["trace_seconds"])
            trace.counters.update(steps=n, frames_per_step=cell["batch"] * (
                int(cell["crop_s"] * inputs.FS) // 256 + 1))
            trace.values["loader_wait_s"] = window_waits
        peak = memory_peak(dev)
        failed = sum(not np.isfinite(x) for x in logged)
        del step, opt, model, loader, feed
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checks, readings = compare(ctx, P, fed, noisy_pcm, clean_pcm, losses, grad1, stats1,
                                   after)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return Outcome({"train_audio_x": audio_s / window_s}, setup_s, steps, failed, checks, peak,
                   trace, {"readings": readings})


def rows_of(batch: np.ndarray, pcm: np.ndarray) -> list:
    """The index in the harness's own pool of each row the loader delivered
    (-1 where a row is none of them)."""
    keys = {pcm[i].tobytes(): i for i in range(len(pcm))}
    as_pcm = np.round(np.asarray(batch, np.float64) * 32768).astype(np.int16)
    return [keys.get(r.tobytes(), -1) for r in as_pcm]


def reference_run(ctx, P: dict, fed: list, noisy_pcm, clean_pcm, flags=gtcrn.no_tf32,
                  rows: int | None = None):
    """The plain reference's three steps on the pairs the loader delivered,
    from the harness's own wavs; also the rows as indices.  ``rows``: step
    on the first ``rows`` of each batch only (a planted fault)."""
    dev = ctx.device
    idx = [rows_of(b, noisy_pcm) for b in fed]
    batches = []
    for r in idx:
        safe = [max(i, 0) for i in r[:rows]]
        batches.append(tuple(torch.from_numpy(pcm[safe].astype(np.float32) / 32768).to(dev)
                             for pcm in (noisy_pcm, clean_pcm)))
    with flags():
        ref = ref_train.train_steps(P, batches, ctx.cell["start_step"])
    return ref, idx


def gaps(P: dict, ref: dict, losses: list, grad1: dict, stats1: dict, after: dict) -> dict:
    """The numbers compared: step 1's loss gap and the worst step's, and the
    worst leaf's gap of first-gradient norms, of trained leaves' change
    norms over the three steps and of running statistics' change norms over
    the first (with the median leaf's change gap, a reading only).  Leaves
    whose reference gradient is under a thousandth of the median leaf's
    (biases ahead of a batch-statistics BatchNorm) move by round-off alone
    and are left out of the change; the running means follow them after
    step 1, so the statistics are compared after step 1."""
    g_ref = ref["grad1"]
    grad_gap, grad_at = worst_leaf_gap(grad1, g_ref)
    gn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in g_ref.items()}
    med = sorted(gn.values())[len(gn) // 2]
    keep = [k for k in gn if gn[k] >= 1e-3 * med]
    change = leaf_gaps({k: after[k] - P[k] for k in keep},
                       {k: ref["params"][k] - P[k] for k in keep})
    change_gap, change_at = worst(change)
    bn_gap, bn_at = worst_leaf_gap({k: stats1[k] - P[k] for k in stats1},
                                   {k: ref["params1"][k] - P[k] for k in stats1})
    return {"loss_gap": max(rel_gap(a, b, 1e-12) for a, b in zip(losses, ref["losses"])),
            "loss1_gap": rel_gap(losses[0], ref["losses"][0], 1e-12),
            "grad_gap": grad_gap, "grad_at": grad_at,
            "change_gap": change_gap, "change_at": change_at,
            "change_median": sorted(change.values())[len(change) // 2],
            "bn_gap": bn_gap, "bn_at": bn_at, "left_out": sorted(set(gn) - set(keep))}


NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "change_gap", "change_median", "bn_gap")


def _as_program(ref: dict, stats_keys) -> tuple:
    """A reference run's results in the program's place."""
    return (ref["losses"], ref["grad1"], {k: ref["params1"][k] for k in stats_keys},
            ref["params"])


def compare(ctx, P, fed, noisy_pcm, clean_pcm, losses, grad1, stats1, after) -> tuple:
    """The checks, and the readings: the program's numbers and, with
    ``ctx.control``, those of the TF32 control and of a half-batch fault,
    each planted in the reference put in the program's place."""
    ref, idx = reference_run(ctx, P, fed, noisy_pcm, clean_pcm)
    flat = [r for rows in idx for r in rows]
    bad_rows = sum(r < 0 for r in flat) + (len(flat) - len(set(flat)))
    g = gaps(P, ref, losses, grad1, stats1, after)
    readings = {"program": {k: g[k] for k in NUMBERS}}
    if ctx.control:
        for name, kw in (("control_tf32", {"flags": gtcrn.tf32}),
                         ("fault_half_batch", {"rows": ctx.cell["batch"] // 2})):
            low, _ = reference_run(ctx, P, fed, noisy_pcm, clean_pcm, **kw)
            gl = gaps(P, ref, *_as_program(low, stats1))
            readings[name] = {k: gl[k] for k in NUMBERS}
    lim = ctx.cell["limits"]
    ctx.log(f"train check: losses {losses!r} vs {ref['losses']!r}; grad gap at {g['grad_at']}, "
            f"change gap at {g['change_at']}, statistics gap at {g['bn_at']}; "
            f"{len(g['left_out'])} leaves left out of the change: {g['left_out']}")
    return [Check("rows_unmatched", bad_rows, 0),
            Check("loss1_gap", g["loss1_gap"], lim["loss1_gap"]),
            Check("loss_gap", g["loss_gap"], lim["loss_gap"]),
            Check("grad_gap", g["grad_gap"], lim["grad_gap"]),
            Check("change_gap", g["change_gap"], lim["change_gap"]),
            Check("bn_gap", g["bn_gap"], lim["bn_gap"])], readings
