"""Linear-warmup + cosine-annealing learning rate (the JAX package's
``train/scheduler.py``; reference utils/scheduler.py:39-51).

Linear 0 -> max_lr over ``warmup_steps``, cosine max -> min until
``decay_until_step``, then ``min_lr``.  The step count lives on the host, so
the rate is a host float32 computed op by op as the JAX package computes it
on the CPU: every operation rounds to float32, and the cosine is the C
library's ``cosf``, which is what XLA's CPU backend calls for a float32 cos
(numpy's and torch's float32 cos differ from it in the last bit).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np

_F = np.float32


@dataclasses.dataclass(frozen=True)
class WarmupCosineConfig:
    warmup_steps: int = 25000
    decay_until_step: int = 250000
    max_lr: float = 1e-3
    min_lr: float = 1e-6


@functools.cache
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.argtypes = [ctypes.c_float]
    libm.cosf.restype = ctypes.c_float
    return libm.cosf


def warmup_cosine_lr(step: int, config: WarmupCosineConfig = WarmupCosineConfig()) -> float:
    """The learning rate at ``step``, a float32 value returned as a float."""
    s = _F(step)
    w, d = _F(config.warmup_steps), _F(config.decay_until_step)
    if s < w:
        return float(_F(config.max_lr) * s / w)
    if s > d:
        return float(_F(config.min_lr))
    # (d - w) and (max - min) are Python-float differences, rounded once
    ratio = min(max((s - w) / _F(float(config.decay_until_step) - float(config.warmup_steps)),
                    _F(0.0)), _F(1.0))
    coeff = _F(0.5) * (_F(1.0) + _F(_cosf()(float(_F(np.pi) * ratio))))
    return float(_F(config.min_lr) + coeff * _F(config.max_lr - config.min_lr))
