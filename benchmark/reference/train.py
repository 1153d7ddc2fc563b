"""Plain DNS3 training step (bglid/GTCRN-Micro ``train.py``, ``loss.py`` and
``utils/scheduler.py`` with ``conf/cfg_train_DNS3.yaml``): Hann STFT, the
training forward with batch-statistics BatchNorm, the hybrid loss, autograd
backward, clip by global norm 3.0 (no epsilon), Adam (0.9, 0.999, 1e-8) at
the warmup-cosine rate of the update's step count, then the running
statistics folded at momentum 0.1 with the unbiased batch variance.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import dsp, gtcrn

B1, B2, EPS = 0.9, 0.999, 1e-8


def lr_at(step: int, warmup: int = 25000, decay_until: int = 250000,
          max_lr: float = 1e-3, min_lr: float = 1e-6) -> float:
    if step < warmup:
        return max_lr * step / warmup
    if step > decay_until:
        return min_lr
    ratio = (step - warmup) / (decay_until - warmup)
    return min_lr + 0.5 * (1 + math.cos(math.pi * ratio)) * (max_lr - min_lr)


def hybrid_loss(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    pr, pi, tr, ti = pred[..., 0], pred[..., 1], true[..., 0], true[..., 1]
    p_mag = torch.sqrt(pr ** 2 + pi ** 2 + 1e-12)
    t_mag = torch.sqrt(tr ** 2 + ti ** 2 + 1e-12)
    p_c, t_c = p_mag ** 0.7, t_mag ** 0.7
    ri = torch.mean((pr / p_c - tr / t_c) ** 2) + torch.mean((pi / p_c - ti / t_c) ** 2)
    mag = torch.mean((p_mag ** 0.3 - t_mag ** 0.3) ** 2)
    win = dsp.sqrt_hann(pred.device)
    y_pred, y_true = dsp.istft(pred, win), dsp.istft(true, win)
    proj = (torch.sum(y_true * y_pred, -1, keepdim=True) * y_true
            / (torch.sum(y_true ** 2, -1, keepdim=True) + 1e-8))
    sisnr = -torch.mean(torch.log10(torch.sum(proj ** 2, -1, keepdim=True)
                                    / (torch.sum((y_pred - proj) ** 2, -1, keepdim=True) + 1e-8)
                                    + 1e-8))
    return 30 * ri + 70 * mag + sisnr


def train_steps(P0: dict, batches: list, start_count: int) -> dict:
    """Run ``len(batches)`` steps from the flat params ``P0`` (left
    unchanged) with fresh Adam moments at update count ``start_count``.
    ``batches``: (noisy, clean) float32 (B, n) pairs on the device.

    Returns ``losses`` (floats), ``grad1`` (the first step's clipped
    gradient by trainable path), ``params1`` and ``params`` (every leaf
    after the first step and after the last)."""
    P = {k: v.detach().clone() for k, v in P0.items()}
    names = [k for k in P if gtcrn.is_trainable(k)]
    mu = {k: torch.zeros_like(P[k]) for k in names}
    nu = {k: torch.zeros_like(P[k]) for k in names}
    win = dsp.hann(next(iter(P.values())).device)
    losses, grad1, params1, count = [], None, None, start_count
    for noisy, clean in batches:
        leaves = {k: P[k].requires_grad_(True) for k in names}
        out, stats = gtcrn.forward(P, dsp.stft(noisy, win), training=True)
        loss = hybrid_loss(out, dsp.stft(clean, win))
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            scale = 1.0 if norm < 3.0 else float(3.0 / norm)
            grads = [g * scale for g in grads]
            if grad1 is None:
                grad1 = dict(zip(names, (g.clone() for g in grads)))
            lr = lr_at(count)
            count += 1
            for k, g in zip(names, grads):
                mu[k] = B1 * mu[k] + (1 - B1) * g
                nu[k] = B2 * nu[k] + (1 - B2) * g * g
                mu_hat = mu[k] / (1 - B1 ** count)
                nu_hat = nu[k] / (1 - B2 ** count)
                P[k] = (P[k].detach() - lr * mu_hat / (torch.sqrt(nu_hat) + EPS))
            for path, (mean, var) in stats.items():
                for leaf, batch in (("running_mean", mean), ("running_var", var)):
                    P[f"{path}.{leaf}"] = 0.9 * P[f"{path}.{leaf}"] + 0.1 * batch
        if params1 is None:
            params1 = {k: v.detach().clone() for k, v in P.items()}
    return {"losses": losses, "grad1": grad1, "params1": params1,
            "params": {k: v.detach() for k, v in P.items()}}
