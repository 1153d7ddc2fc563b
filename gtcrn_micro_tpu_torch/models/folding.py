"""Inference-time parameter folding: BatchNorm into the conv before it.

Counterpart of the JAX package's ``models/folding.py``.  Eval-mode BatchNorm
is the affine ``y = x s + t`` with ``s = gamma / sqrt(running_var + eps)``
and ``t = beta - running_mean s``; ``fold_bn_params`` moves it into the
preceding conv or pointwise weights and bias and resets the BatchNorm to
the identity (gamma 1, beta 0, mean 0, var 1 - eps), so the same model
definition gives the same output up to float32 reassociation.
"""

from __future__ import annotations

import torch

EPS = 1e-5


def _fold_into(conv: dict, bn: dict, out_axis: int) -> tuple[dict, dict]:
    s = bn["gamma"] / torch.sqrt(bn["running_var"] + EPS)
    t = bn["beta"] - bn["running_mean"] * s
    w = conv["w"]
    shape = [1] * w.dim()
    shape[out_axis] = -1
    new_conv = dict(conv, w=w * s.reshape(shape))
    new_conv["b"] = conv["b"] * s + t if "b" in conv else t
    ident = {
        "gamma": torch.ones_like(s),
        "beta": torch.zeros_like(s),
        "running_mean": torch.zeros_like(s),
        # normalisation divides by sqrt(var + eps); var = 1 - eps divides by 1
        "running_var": torch.full_like(s, 1.0 - EPS),
    }
    return new_conv, ident


def fold_bn_params(params: dict) -> dict:
    """Equivalent params (nested dict of tensors) with every conv + BN pair
    folded; the input is not modified."""

    def fold_convblock(blk):  # {'conv', 'bn'[, 'act']}
        blk = dict(blk)
        blk["conv"], blk["bn"] = _fold_into(blk["conv"], blk["bn"], out_axis=3)
        return blk

    def fold_gtconv(blk):
        blk = dict(blk)
        blk["point_conv1"], blk["point_bn1"] = _fold_into(
            blk["point_conv1"], blk["point_bn1"], out_axis=1)
        blk["depth_conv"], blk["depth_bn"] = _fold_into(
            blk["depth_conv"], blk["depth_bn"], out_axis=3)
        blk["point_conv2"], blk["point_bn2"] = _fold_into(
            blk["point_conv2"], blk["point_bn2"], out_axis=1)
        return blk

    def fold_tcn(blk):
        blk = dict(blk)
        blk["conv1"], blk["bn1"] = _fold_into(blk["conv1"], blk["bn1"], 1)
        blk["conv2"], blk["bn2"] = _fold_into(blk["conv2"], blk["bn2"], 3)
        blk["conv3"], blk["bn3"] = _fold_into(blk["conv3"], blk["bn3"], 1)
        return blk

    out = dict(params)
    enc = dict(params["encoder"])
    enc["en0"] = fold_convblock(enc["en0"])
    enc["en1"] = fold_convblock(enc["en1"])
    for k in ("en2", "en3", "en4"):
        enc[k] = fold_gtconv(enc[k])
    out["encoder"] = enc
    for stack in ("gtcn1", "gtcn2"):
        out[stack] = {k: fold_tcn(v) for k, v in params[stack].items()}
    dec = dict(params["decoder"])
    for k in ("de0", "de1", "de2"):
        dec[k] = fold_gtconv(dec[k])
    dec["de3"] = fold_convblock(dec["de3"])
    dec["de4"] = fold_convblock(dec["de4"])
    out["decoder"] = dec
    return out
