"""Training entry point (the JAX package's ``train/train.py``; reference
train.py:37-473):

    python -m gtcrn_micro_tpu_torch.train.train -C <cfg.yaml> [--device cpu] [--max-steps N]
    torchrun --nproc_per_node=N -m gtcrn_micro_tpu_torch.train.train -C <cfg.yaml> --distributed

One process on one device, or with ``--distributed`` one process per GPU
(gloo processes with ``--device cpu``) in the group ``torchrun`` describes
(``parallel/mesh.init_distributed``).  Every rank draws the same file
subsample and batch order from the same seed and steps on its own rows of
each batch (``parallel/mesh.shard_batch_multiprocess``); the step averages
the gradients and takes the BatchNorm statistics over the global batch
(``trainer.make_train_step(group=...)``), so every rank holds the same
model.  Rank 0 alone archives the config, validates, writes metrics, samples
and checkpoints and keeps the best snapshot; every rank restores on resume.
The JAX ``run`` drives every local device from one process; this port runs
one process per GPU instead.  Per epoch:

- a random file subsample (reference dataloader.py:108-111);
- one training step per batch (STFT, forward, backward, clip, Adam, BN fold;
  ``trainer.make_train_step``), the losses kept on the device and summed
  every ``log_every`` steps;
- validation: the hybrid loss and a per-utterance quality score, wideband
  PESQ from the ``pesq`` package where it imports, else the port's numpy
  ``eval/pesq.py`` (reference train.py:356-358); a sample wav at epoch 1 and
  every 10th epoch;
- a checkpoint ``{params, opt_state, epoch, step}`` every
  ``save_checkpoint_interval`` epochs, and the best-by-score snapshot;
- metrics to ``logs/metrics.jsonl`` (and TensorBoard where tensorboardX
  imports).

``run`` takes a ``Config`` or a plain dict and never needs PyYAML: it keeps
the resolved config as ``config.yaml`` where PyYAML imports and as
``config.json`` where it does not.  Only ``main`` needs PyYAML, to read
``-C``.
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import time
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.dsp.stft import hann_window, istft
from gtcrn_micro_tpu_torch.io.wav import write_wav
from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params, nest
from gtcrn_micro_tpu_torch.models.registry import get_model
from gtcrn_micro_tpu_torch.parallel.mesh import (
    init_distributed,
    replicate_multiprocess,
    shard_batch_multiprocess,
)
from gtcrn_micro_tpu_torch.train.dataloader import PairedWavDataset, PrefetchLoader
from gtcrn_micro_tpu_torch.train.loss import HybridLossConfig
from gtcrn_micro_tpu_torch.train.scheduler import WarmupCosineConfig, warmup_cosine_lr
from gtcrn_micro_tpu_torch.train.trainer import (
    TrainerConfig,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from gtcrn_micro_tpu_torch.utils.checkpoint import BestTracker, CheckpointManager
from gtcrn_micro_tpu_torch.utils.config import _wrap
from gtcrn_micro_tpu_torch.utils.logging import MetricWriter

_DTYPES = {"fp32": None, "bf16": torch.bfloat16}


@functools.cache
def _pesq_scorer():
    """The wideband PESQ scorer, resolved once: the ITU ``pesq`` package
    where it imports (the reference's validation criterion, train.py:356-362),
    else the port's from-spec ``eval/pesq.py``."""
    try:
        from pesq import pesq  # type: ignore
    except ImportError:
        from gtcrn_micro_tpu_torch.eval.pesq import pesq_wb

        return lambda ref, est, fs: pesq_wb(ref, est, fs)
    return lambda ref, est, fs: pesq(fs, ref, est, "wb")


def quality_score(clean: np.ndarray, enhanced: np.ndarray, fs: int) -> float:
    """Per-utterance validation score: wideband PESQ (reference recipe).
    NaN when the scorer fails (e.g. no utterance in silence); callers
    aggregate NaN-aware."""
    try:
        return float(_pesq_scorer()(clean, enhanced, fs))
    except Exception:  # one unscorable utterance must not stop training
        return np.nan


def _resolve_exp_path(cfg: TrainerConfig) -> str:
    """A fresh run gets ``exp_path`` dated to the minute.  A resumed run
    takes ``exp_path`` itself when it holds checkpoints, else the newest
    dated ``exp_path_*`` run that does, and raises when there is none: a
    silent fresh start while the user believes they resumed is the failure
    to avoid."""
    if not cfg.resume:
        return cfg.exp_path + "_" + datetime.now().strftime("%Y-%m-%d-%Hh%Mm")
    if os.path.isdir(os.path.join(cfg.exp_path, "checkpoints")):
        return cfg.exp_path
    runs = sorted(d for d in glob.glob(cfg.exp_path + "_*")
                  if os.path.isdir(os.path.join(d, "checkpoints")))
    if not runs:
        raise FileNotFoundError(f"resume=true but no checkpoints under {cfg.exp_path} "
                                f"or any {cfg.exp_path}_* run")
    return runs[-1]


def _archive_config(config, exp_path: str) -> None:
    """The resolved config as ``config.yaml``, or ``config.json`` without
    PyYAML (the reference snapshots config and code, train.py:172-186)."""
    try:
        import yaml
    except ImportError:
        with open(os.path.join(exp_path, "config.json"), "w") as f:
            json.dump(config.to_dict(), f, indent=1)
        return
    with open(os.path.join(exp_path, "config.yaml"), "w") as f:
        yaml.safe_dump(config.to_dict(), f)


def _on_every_rank(group, value):
    """Rank 0's ``value`` on every rank; an exception rank 0 holds is raised
    on every rank."""
    if group is not None:
        box = [value]
        dist.broadcast_object_list(box, src=0, group=group)
        value = box[0]
    if isinstance(value, Exception):
        raise value
    return value


def run(config, *, device=None, distributed: bool = False, max_steps: int | None = None) -> str:
    """Train as ``config`` says (a ``utils.config.Config`` or dict of the
    ``configs/cfg_train_*.yaml`` form) on ``device`` (``None``: CUDA);
    ``trainer.epochs`` is the TOTAL epoch count, so a resumed run finishes
    the same recipe.  ``distributed``: join the ``torchrun`` group as one
    rank of data-parallel training (module docstring; the global batch
    size must divide by the world size).  Returns the experiment
    directory."""
    owned = distributed and not dist.is_initialized()
    if distributed:
        rank, world, dev, group = init_distributed(device)
    else:
        rank, world, dev, group = 0, 1, resolve_device(device), None
    try:
        return _run(config, dev, rank, world, group, max_steps)
    finally:
        if owned:
            dist.destroy_process_group()


def _run(config, dev, rank: int, world: int, group, max_steps: int | None) -> str:
    lead = rank == 0
    config = _wrap(dict(config))
    trainer_kw = {**config.get("trainer", {}), **config.get("trainer_overrides", {})}
    trainer_cfg = TrainerConfig(**{k: v for k, v in trainer_kw.items()
                                   if k in TrainerConfig.__dataclass_fields__})
    if trainer_cfg.precision not in _DTYPES:
        raise ValueError(f"trainer.precision {trainer_cfg.precision!r}: expected one of "
                         f"{sorted(_DTYPES)}")
    sched_cfg = WarmupCosineConfig(**{k: float(v) if "lr" in k else int(v)
                                      for k, v in config.get("scheduler", {})
                                      .get("kwargs", {}).items()})
    loss_cfg = HybridLossConfig(**{k: v for k, v in config.get("loss", {}).items()
                                   if k in HybridLossConfig.__dataclass_fields__})

    loader_cfg = config.get("train_dataloader", {})
    if loader_cfg.get("batch_size", 0) % world:
        raise ValueError(f"train_dataloader.batch_size {loader_cfg.get('batch_size')} does "
                         f"not divide by the world size {world}")
    try:
        exp_path = _resolve_exp_path(trainer_cfg) if lead else None
    except FileNotFoundError as e:
        exp_path = e
    exp_path = _on_every_rank(group, exp_path)  # one dated name for every rank
    if lead:
        os.makedirs(exp_path, exist_ok=True)
        _archive_config(config, exp_path)

    train_ds = PairedWavDataset(**config["train_dataset"])
    valid_ds = PairedWavDataset(**config["valid_dataset"])
    train_loader = PrefetchLoader(train_ds, **loader_cfg)
    valid_loader = PrefetchLoader(valid_ds, shuffle=False, drop_last=False,
                                  **config.get("valid_dataloader", {}))

    model = get_model(config.get("network", "gtcrn_micro"), device=dev,
                      **config.get("network_config", {}))
    model.load_params(init_params(torch.Generator().manual_seed(config.get("seed", 43)),
                                  device=dev))
    optimizer = make_optimizer(model, sched_cfg, trainer_cfg.clip_grad_norm, device=dev)
    train_step = make_train_step(model, optimizer, loss_cfg, trainer_cfg,
                                 compute_dtype=_DTYPES[trainer_cfg.precision], device=dev,
                                 group=group)
    eval_step = make_eval_step(model, loss_cfg, trainer_cfg, device=dev)

    ckpt = CheckpointManager(os.path.join(exp_path, "checkpoints"))
    start_epoch, step = 1, 0
    if trainer_cfg.resume and ckpt.latest_step() is not None:
        restored = ckpt.restore()
        model.load_params(restored["params"])
        optimizer.load_state_dict(restored["opt_state"])
        start_epoch, step = int(restored["epoch"]) + 1, int(restored["step"])
        if lead:
            print(f"resumed from step {step} (epoch {start_epoch - 1})")
    if group is not None:  # every rank starts from rank 0's bytes
        replicate_multiprocess(list(model.state_dict().values()) + optimizer.mu + optimizer.nu,
                               group)

    window = hann_window(trainer_cfg.win_len, device=dev)
    best = BestTracker(os.path.join(exp_path, "checkpoints"))
    fs = trainer_cfg.samplerate
    writer = MetricWriter(os.path.join(exp_path, "logs")) if lead else None
    try:
        for epoch in range(start_epoch, trainer_cfg.epochs + 1):
            # --- train ---
            train_ds.sample_data_per_epoch()
            t0 = time.time()
            total_loss, n_batches = 0.0, 0
            # the losses stay on the device between log points: reading one
            # waits for the device and stalls the queue of steps
            pending: list[torch.Tensor] = []
            for batch in train_loader:
                noisy, clean = shard_batch_multiprocess(batch, rank, world)
                pending.append(train_step(noisy, clean))
                n_batches += 1
                step += 1
                if step % trainer_cfg.log_every == 0:
                    total_loss += float(torch.stack(pending).sum())
                    pending.clear()
                    if lead:  # the rate after the increment, as the JAX package logs it
                        writer.scalars(step, train_loss=total_loss / n_batches,
                                       lr=warmup_cosine_lr(step, sched_cfg))
                if max_steps is not None and step >= max_steps:
                    break
            if pending:
                total_loss += float(torch.stack(pending).sum())
            stop = max_steps is not None and step >= max_steps
            if not lead:  # validation, checkpoints and logs are rank 0's
                if stop:
                    break
                continue
            train_loss = total_loss / max(n_batches, 1)
            print(f"epoch {epoch}: train_loss={train_loss:.3f} "
                  f"({n_batches} steps, {time.time() - t0:.0f}s)")

            # --- validate ---
            val_loss, val_score, n_utts, n_val = 0.0, 0.0, 0, 0
            for vi, (noisy, clean) in enumerate(valid_loader):
                n_val += 1
                loss, enhanced_spec = eval_step(noisy, clean)
                val_loss += float(loss)
                wav = istft(enhanced_spec, window, length=clean.shape[1]).cpu().numpy()
                if clean.dtype == np.int16:  # int16 transfer path: score in f32
                    clean = clean.astype(np.float32) / 32768.0
                for b in range(wav.shape[0]):
                    s = quality_score(clean[b], wav[b], fs)
                    if np.isfinite(s):  # one failed score must not poison the epoch
                        val_score += s
                        n_utts += 1
                if vi == 0 and (epoch == 1 or epoch % 10 == 0):
                    sample_dir = os.path.join(exp_path, "val_samples")
                    os.makedirs(sample_dir, exist_ok=True)
                    write_wav(os.path.join(sample_dir, f"sample_1_enh_epoch{epoch:03d}.wav"),
                              wav[0], fs)
            # a mean over batches, whether or not the scorer succeeded
            val_loss /= max(n_val, 1)
            score = val_score / max(n_utts, 1)
            writer.scalars(step, val_loss=val_loss, val_score=score, epoch=epoch)
            print(f"epoch {epoch}: val_loss={val_loss:.3f} score={score:.4f}")

            # --- checkpoint: periodic, and best-by-score every epoch
            # (reference train.py:217-221) ---
            state = {"params": nest({k: v.detach().cpu().clone()
                                     for k, v in model.state_dict().items()}),
                     "opt_state": optimizer.state_dict(), "epoch": epoch, "step": step}
            if epoch % trainer_cfg.save_checkpoint_interval == 0:
                ckpt.save(step, state)
            best.update(step, score, state)

            if stop:
                break
    finally:
        if writer is not None:
            writer.close()
        ckpt.close()
    if group is not None:  # every rank returns once rank 0's checkpoints are written
        dist.barrier(group)
    if lead:
        print(f"Training done. exp_path={exp_path} best_score={best.best_score:.4f}")
    return exp_path


def main(args=None) -> None:
    from gtcrn_micro_tpu_torch.utils.config import load_config

    parser = argparse.ArgumentParser()
    parser.add_argument("-C", "--config", default="configs/cfg_train_dns3.yaml")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--distributed", action="store_true",
                        help="one rank of the torchrun group (data parallel)")
    ns = parser.parse_args(args)
    run(load_config(ns.config), device=ns.device, distributed=ns.distributed,
        max_steps=ns.max_steps)


if __name__ == "__main__":
    main()
