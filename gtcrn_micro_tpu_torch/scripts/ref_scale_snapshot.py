"""Snapshot the reference-scale traversal's evidence into the repository.

Counterpart of the root ``scripts/ref_scale_snapshot.py``.
``scripts/ref_scale_run.py`` writes its summary only when the trainer
finishes; this freezes whatever a run under ``--root`` shows now -- a run
still going, or one killed mid-flight -- into ``--out``
(``docs/evidence/ref_scale_h100/`` by default): ``summary.json``, a copy of
``logs/metrics.jsonl`` and the driver log's kill and relaunch lines.

The summary is ``ref_scale_run.summarize`` (seams, checkpoints on disk, the
best score, the lr at the knee) and the root script's own keys: the lr
curve's first, last and peak points, whether the warmup knee was crossed,
the first and last train loss, the record count.  Unlike the root script it
reads a run that has no ``logs/metrics.jsonl`` yet (a summary with
``final_logged_step`` 0, and no copy), and it counts only whole checkpoints.
It reads files only.

    python -m gtcrn_micro_tpu_torch.scripts.ref_scale_snapshot [--root /tmp/gtcrn_ref_scale]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import time
from pathlib import Path

from gtcrn_micro_tpu_torch.scripts.ref_scale_run import exp_dir, read_metrics, recipe, summarize

REPO = Path(__file__).resolve().parents[2]
EVENTS = r"SIGKILL|relaunch|launch|corpus|completed|exited"


def snapshot(root: str, driver_log: str) -> dict | None:
    """The summary of the newest run under ``root``; None when there is no
    run."""
    d = exp_dir(root)
    if d is None:
        return None
    recs = read_metrics(d)
    lr = [(r["step"], r["lr"]) for r in recs if "lr" in r]
    tl = [(r["step"], r["train_loss"]) for r in recs if "train_loss" in r]
    warmup = recipe(d)[0]
    driver_lines: list[str] = []
    if os.path.exists(driver_log):
        with open(driver_log) as f:
            driver_lines = [ln.rstrip() for ln in f if re.search(EVENTS, ln)]
    s = summarize(root)
    return {
        "snapshot_unix": time.time(),
        **s,
        "final_logged_step": s["final_step"],
        "n_metric_records": len(recs),
        "lr_first": lr[0] if lr else None,
        "lr_last": lr[-1] if lr else None,
        "lr_peak": max(lr, key=lambda sv: sv[1]) if lr else None,
        "warmup_knee_crossed": s["final_step"] >= warmup,
        "driver_log_events": driver_lines,
        "train_loss_first": tl[0] if tl else None,
        "train_loss_last": tl[-1] if tl else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="freeze a reference-scale run's evidence")
    ap.add_argument("--root", default="/tmp/gtcrn_ref_scale")
    ap.add_argument("--driver-log", default="/tmp/ref_scale_driver.log")
    ap.add_argument("--out", default=str(REPO / "docs" / "evidence" / "ref_scale_h100"))
    args = ap.parse_args(argv)

    summary = snapshot(args.root, args.driver_log)
    if summary is None:
        print("no run under", args.root)
        return 1
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    metrics = os.path.join(summary["exp_dir"], "logs/metrics.jsonl")
    if os.path.exists(metrics):
        shutil.copy(metrics, os.path.join(args.out, "metrics.jsonl"))
    if summary["driver_log_events"]:
        with open(os.path.join(args.out, "driver_events.log"), "w") as f:
            f.write("\n".join(summary["driver_log_events"]) + "\n")
    print(json.dumps(summary, indent=1))
    print("evidence ->", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
