"""Training checkpoints on ``torch.save`` (the JAX package's
``utils/checkpoint.py``, which uses orbax).

A checkpoint is the state ``{"params": nested dict by JAX path, "opt_state":
{"count", "mu", "nu"}, "epoch", "step"}`` of CPU tensors and integers, in
``<directory>/<step>/state.pt``; :meth:`CheckpointManager.restore` reads it
back with ``torch.load(weights_only=True)``.  A write goes to a temporary
file that is renamed into place, so a checkpoint is either whole or absent.
The learning rate is a function of the optimizer's count, so no scheduler
state is saved.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

_STATE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _STATE)

    def steps(self) -> list[int]:
        """The steps with a whole checkpoint, oldest first."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(self._path(int(d))))

    def save(self, step: int, state: dict) -> None:
        path = self._path(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> dict:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def close(self) -> None:
        """Nothing is pending: :meth:`save` returns once the file is in place."""


class BestTracker:
    """Track the best validation score and keep its state snapshot in
    ``<directory>/best``.

    The score is kept next to the snapshot (``best_score.json``) and read
    back on construction, so a resumed run cannot overwrite the saved best
    checkpoint with a worse model."""

    def __init__(self, directory: str):
        self.directory = directory
        self.best_score = -np.inf
        self.best_step = None
        self._meta = os.path.join(directory, "best_score.json")
        if os.path.exists(self._meta):
            with open(self._meta) as f:
                meta = json.load(f)
            self.best_score = float(meta["best_score"])
            self.best_step = meta.get("best_step")

    def update(self, step: int, score: float, state: dict) -> bool:
        if not score > self.best_score:
            return False
        self.best_score, self.best_step = score, step
        CheckpointManager(os.path.join(self.directory, "best"), max_to_keep=1).save(step, state)
        with open(self._meta + ".tmp", "w") as f:
            json.dump({"best_score": float(score), "best_step": step}, f)
        os.replace(self._meta + ".tmp", self._meta)
        return True
