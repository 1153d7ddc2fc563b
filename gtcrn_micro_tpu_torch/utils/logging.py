"""Metric logging: a JSONL event stream always, TensorBoard scalars where
tensorboardX imports (the JAX package's ``utils/logging.py``; the reference
logs lr / train_loss / val_loss / pesq per epoch, train.py:293-299,
397-402)."""

from __future__ import annotations

import json
import os
import time


class MetricWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir)

    def scalars(self, step: int, **values: float) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
