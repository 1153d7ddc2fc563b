"""Reference-scale training traversal with a mid-run SIGKILL and a resume.

Counterpart of the root ``scripts/ref_scale_run.py``.  It trains the DNS3
recipe's shape -- batch 8 x 10 s crops, warmup to step 25,000 and then the
cosine decay toward step 250,000 (reference conf/cfg_train_DNS3.yaml,
utils/scheduler.py:39-51), a checkpoint every epoch, the best snapshot --
far enough to cross the warmup knee (22 epochs x 1,250 steps = 27,500
steps), SIGKILLs the trainer mid-epoch and resumes it to the same recipe's
end (``train.run`` with ``trainer.resume``).  The corpus is the synthetic
``make_smoke_data`` one: 10,000 training clips of 10 s (the reference's
``num_data_per_epoch``; batch 8 gives 1,250 steps an epoch) and 8
validation clips.

The trainer runs in a process of its own, ``python -m
gtcrn_micro_tpu_torch.train.train -C <config>``, on ``--device`` (default
cuda).  A watchdog polls its metrics and its resident memory: it SIGKILLs
the trainer once at ``--kill-at-step``, and again whenever the trainer's RSS
crosses ``--rss-limit-gb``, and relaunches it with ``resume: true`` each
time (up to ``--max-restarts``).  Each relaunch is one more kill-and-resume
seam.  A resume starts from the newest whole checkpoint
(``utils/checkpoint.CheckpointManager.steps``): a kill during a save leaves
``<step>/state.pt.tmp`` and no ``state.pt``, and that step does not count.

At the end ``<root>/summary.json`` holds :func:`summarize` and the run's
own records:

- the lr traverse: the logged lr rises linearly to ``max_lr`` at the
  warmup step (``lr_peak_step``) and decreases after it;
- ``seam_continuity``: every point where the append-only
  ``logs/metrics.jsonl`` steps back (the resumed run re-logs the killed
  epoch's steps), with the mean train loss of the 10 records before and
  after it; ``driver_seams``: the checkpoint step each relaunch resumed from;
- retention: the checkpoints on disk (the ``max_to_keep`` window) and
  ``best_score.json``.

    python -m gtcrn_micro_tpu_torch.scripts.ref_scale_run [--kill-at-step 13000]
        [--root /tmp/gtcrn_ref_scale] [--resume-only] [--device cpu]

``main`` and :func:`base_config` take the horizon as keyword arguments
(clips, seconds, warmup, epochs, steps per epoch, ``log_every``, the poll
interval), the recipe's values by default, so that a test can run the same
driver in seconds.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CLIPS = 10000            # training clips: one epoch's sample (num_data_per_epoch)
SECONDS = 10.0           # crop and clip length
WARMUP = 25000           # warmup_steps of the DNS3 schedule
STEPS_PER_EPOCH = 1250   # 10,000 clips / batch 8
TOTAL_EPOCHS = 22        # 27,500 steps: the knee at 25k + 2.5k cosine steps
LOG_EVERY = 50
POLL_S = 20.0
N_VAL = 8


def base_config(root: str, *, clips: int = CLIPS, seconds: float = SECONDS,
                warmup: int = WARMUP, epochs: int = TOTAL_EPOCHS,
                steps_per_epoch: int = STEPS_PER_EPOCH, log_every: int = LOG_EVERY) -> dict:
    """The recipe (the root script's ``base_config``); the batch is
    ``clips // steps_per_epoch``."""
    return {
        "network": "gtcrn_micro",
        "network_config": {"n_fft": 512, "hop_len": 256, "win_len": 512},
        "seed": 43,
        "scheduler": {"kwargs": {
            # the reference DNS3 schedule
            "warmup_steps": warmup, "decay_until_step": 250000,
            "max_lr": 1e-3, "min_lr": 1e-6,
        }},
        "loss": {"compress_factor": 0.3, "lamda_ri": 30, "lamda_mag": 70},
        "train_dataset": {
            "noisy_root": os.path.join(root, "data/train/noisy"),
            "fs": 16000, "length_seconds": seconds,
            "num_data_per_epoch": clips, "random_start": False,
            "train": True,
            # raw 16-bit PCM to the device, dequantized there (bit-exact)
            "transfer_dtype": "int16",
        },
        "train_dataloader": {"batch_size": clips // steps_per_epoch, "num_workers": 2,
                             "drop_last": True},
        "valid_dataset": {
            "noisy_root": os.path.join(root, "data/val/noisy"),
            "fs": 16000, "length_seconds": seconds, "train": False,
            "transfer_dtype": "int16",
        },
        "valid_dataloader": {"batch_size": 4, "num_workers": 2},
        "samplerate": 16000,
        "trainer": {
            "epochs": epochs, "save_checkpoint_interval": 1,
            "clip_grad_norm": 3.0,
            "exp_path": os.path.join(root, "exp/ref_scale"),
            "resume": False, "precision": "bf16", "log_every": log_every,
        },
    }


def ensure_corpus(root: str, clips: int = CLIPS, seconds: float = SECONDS) -> None:
    """The synthetic corpus under ``<root>/data`` (seed 43), made once per
    shape: a marker records the clips and seconds it was made for."""
    from gtcrn_micro_tpu_torch.utils.make_smoke_data import make_smoke_data

    marker = os.path.join(root, "data", ".complete")
    shape = f"{clips} {seconds}"
    if os.path.exists(marker) and Path(marker).read_text() == shape:
        print("corpus already present", flush=True)
        return
    t0 = time.time()
    make_smoke_data(os.path.join(root, "data"), n_train=clips, n_val=N_VAL, seconds=seconds,
                    seed=43)
    Path(marker).write_text(shape)
    print(f"corpus generated in {time.time() - t0:.0f}s", flush=True)


def exp_dir(root: str) -> str | None:
    """The run's directory: the newest dated ``exp/ref_scale_*``."""
    runs = sorted(glob.glob(os.path.join(root, "exp/ref_scale_*")))
    return runs[-1] if runs else None


def read_metrics(d: str | None) -> list[dict]:
    """The records of ``<d>/logs/metrics.jsonl``; none when it does not
    exist, and a line cut short by a kill is skipped."""
    path = os.path.join(d, "logs/metrics.jsonl") if d else None
    if path is None or not os.path.exists(path):
        return []
    recs = []
    with open(path) as f:
        for line in f:
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return recs


def last_logged_step(root: str) -> int:
    return max((r.get("step", 0) for r in read_metrics(exp_dir(root))), default=0)


def checkpoint_steps(d: str | None) -> list[int]:
    """The steps with a whole checkpoint in ``<d>/checkpoints``, oldest
    first (a partial ``<step>/state.pt.tmp`` is not one)."""
    from gtcrn_micro_tpu_torch.utils.checkpoint import CheckpointManager

    ckpt = os.path.join(d, "checkpoints") if d else None
    if ckpt is None or not os.path.isdir(ckpt):
        return []
    return CheckpointManager(ckpt).steps()


def seam_continuity(train_loss: list[tuple]) -> list[dict]:
    """Each point where the logged steps stop increasing (a resume
    re-logging the killed epoch), with the mean train loss of the 10
    records before and after it."""
    seams = []
    for i in range(1, len(train_loss)):
        if train_loss[i][0] <= train_loss[i - 1][0]:
            before = [v for _, v in train_loss[max(0, i - 10):i]]
            after = [v for _, v in train_loss[i:i + 10]]
            seams.append({
                "resumed_at_step": train_loss[i][0],
                "loss_before_mean": sum(before) / len(before),
                "loss_after_mean": sum(after) / len(after),
            })
    return seams


def recipe(d: str | None) -> tuple[int, int, int]:
    """(warmup steps, log interval, total steps) of the run's archived
    ``config.yaml``; the recipe's without one."""
    from gtcrn_micro_tpu_torch.utils.config import load_config

    path = os.path.join(d, "config.yaml") if d else None
    if path is None or not os.path.exists(path):
        return WARMUP, LOG_EVERY, TOTAL_EPOCHS * STEPS_PER_EPOCH
    cfg = load_config(path)
    per_epoch = (cfg["train_dataset"]["num_data_per_epoch"]
                 // cfg["train_dataloader"]["batch_size"])
    return (int(cfg["scheduler"]["kwargs"]["warmup_steps"]), int(cfg["trainer"]["log_every"]),
            int(cfg["trainer"]["epochs"]) * per_epoch)


def summarize(root: str) -> dict:
    """What the run's files show (the root script's verification): the lr
    peak and the lr just before the knee, at it and at the last step; the
    seams; the checkpoints on disk and the best score.  Tolerates a run
    still going or killed mid-flight."""
    d = exp_dir(root)
    recs = read_metrics(d)
    lr = [(r["step"], r["lr"]) for r in recs if "lr" in r]
    tl = [(r["step"], r["train_loss"]) for r in recs if "train_loss" in r]
    warmup, log_every, total = recipe(d)
    lr_at = dict(lr)
    best = None
    best_path = os.path.join(d, "checkpoints/best_score.json") if d else None
    if best_path and os.path.exists(best_path):
        with open(best_path) as f:
            best = json.load(f)
    return {
        "exp_dir": d,
        "seam_continuity": seam_continuity(tl),
        "final_step": max((s for s, _ in tl), default=0),
        "lr_peak_step": max(lr, key=lambda sv: sv[1])[0] if lr else None,
        f"lr_at_{warmup - log_every}": lr_at.get(warmup - log_every),
        f"lr_at_{warmup}": lr_at.get(warmup),
        f"lr_at_{total}": lr_at.get(total),
        "checkpoint_steps_on_disk": checkpoint_steps(d),
        "best": best,
    }


def launch(cfg_path: str, log_path: str, device: str | None) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "gtcrn_micro_tpu_torch.train.train", "-C", cfg_path]
    with open(log_path, "w") as logf:  # the child keeps its own descriptor
        return subprocess.Popen(cmd + (["--device", device] if device else []),
                                stdout=logf, stderr=subprocess.STDOUT, cwd=REPO)


def rss_gb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1048576.0
    except OSError:
        pass
    return 0.0


def _kill(proc: subprocess.Popen) -> None:
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait()


def main(argv=None, *, clips: int = CLIPS, seconds: float = SECONDS, warmup: int = WARMUP,
         epochs: int = TOTAL_EPOCHS, steps_per_epoch: int = STEPS_PER_EPOCH,
         log_every: int = LOG_EVERY, poll_s: float = POLL_S) -> int:
    from gtcrn_micro_tpu_torch import resolve_device
    from gtcrn_micro_tpu_torch.utils.config import save_config

    ap = argparse.ArgumentParser(description="the reference-scale traversal with a SIGKILL seam")
    ap.add_argument("--root", default="/tmp/gtcrn_ref_scale")
    ap.add_argument("--kill-at-step", type=int, default=13000,
                    help="SIGKILL run 1 at this logged step (mid-epoch 11; the epoch-10 "
                         "checkpoint at 12,500 is the resume point)")
    ap.add_argument("--resume-only", action="store_true",
                    help="skip the fresh launch: resume the existing run under --root (a run "
                         "killed from outside is itself a mid-epoch seam)")
    ap.add_argument("--rss-limit-gb", type=float, default=55.0,
                    help="SIGKILL and resume the trainer when its RSS crosses this")
    ap.add_argument("--max-restarts", type=int, default=12)
    ap.add_argument("--device", default=None, help="the trainer's device; default cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # refuse at once where the trainer would find no card
    root = os.path.abspath(args.root)
    os.makedirs(root, exist_ok=True)

    ensure_corpus(root, clips, seconds)
    horizon = dict(clips=clips, seconds=seconds, warmup=warmup, epochs=epochs,
                   steps_per_epoch=steps_per_epoch, log_every=log_every)
    cfg1 = base_config(root, **horizon)
    cfg2 = base_config(root, **horizon)
    cfg2["trainer"]["resume"] = True
    p1, p2 = os.path.join(root, "run1.yaml"), os.path.join(root, "run2.yaml")
    save_config(cfg1, p1)
    save_config(cfg2, p2)

    # -- the watchdog: run to completion through the kill-and-resume seams
    t0 = time.time()
    proc = None
    run_no = 0
    intentional_done = args.resume_only
    killed_at = last_logged_step(root) if args.resume_only else None
    seams: list[dict] = []
    if args.resume_only:
        print(f"--resume-only: existing run last logged step {killed_at}", flush=True)
    try:
        while True:
            if proc is None:
                run_no += 1
                if run_no > args.max_restarts:
                    print(f"giving up after {args.max_restarts} restarts", flush=True)
                    return 3
                fresh = run_no == 1 and not args.resume_only
                if fresh:
                    print("launch fresh run", flush=True)
                else:
                    seam = max(checkpoint_steps(exp_dir(root)), default=0)
                    seams.append({"resumed_from_ckpt_step": seam,
                                  "killed_at_logged_step": last_logged_step(root)})
                    print(f"relaunch {run_no}: resuming from checkpoint step {seam}", flush=True)
                    time.sleep(min(10.0, poll_s))
                # log names carry the driver's start time, so a --resume-only
                # pass keeps the earlier attempt's logs
                proc = launch(p1 if fresh else p2,
                              os.path.join(root, f"run{run_no}_{int(t0)}.log"), args.device)
            time.sleep(poll_s)
            rc = proc.poll()
            if rc is not None:
                step = last_logged_step(root)
                if rc == 0:
                    print(f"trainer completed (rc=0) at step {step}", flush=True)
                    break
                print(f"trainer exited rc={rc} at step {step}; relaunching", flush=True)
                proc = None
                continue
            step = last_logged_step(root)
            rss = rss_gb(proc.pid)
            print(f"  t={time.time() - t0:7.0f}s run={run_no} step={step} rss={rss:5.1f} GB",
                  flush=True)
            if not intentional_done and step >= args.kill_at_step:
                _kill(proc)
                proc = None
                intentional_done = True
                killed_at = step
                print(f"SIGKILL (intentional seam) at logged step {step}", flush=True)
            elif rss > args.rss_limit_gb:
                _kill(proc)
                proc = None
                print(f"SIGKILL (rss watchdog: {rss:.1f} GB > {args.rss_limit_gb} GB) at logged "
                      f"step {step}", flush=True)
    finally:
        if proc is not None and proc.poll() is None:  # an interrupted driver leaves no trainer
            _kill(proc)

    # -- verify
    s = summarize(root)
    summary = {"exp_dir": s.pop("exp_dir"), "killed_at_logged_step": killed_at,
               "driver_seams": seams, **s, "restarts": run_no - 1,
               "total_wall_s": time.time() - t0}
    out = os.path.join(root, "summary.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1), flush=True)
    print(f"summary -> {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
