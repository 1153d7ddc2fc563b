"""Importer: the reference PyTorch checkpoint -> the port's params tree.

Counterpart of the JAX package's ``io/torch_ckpt.py``.  The reference ships
``ckpts/best_model_dns3.tar``, a dict ``{epoch, optimizer, scheduler,
model}`` (388 tensors).  Its state dict maps onto the canonical layouts:

- Conv2d OIHW ``(O, I/g, kT, kF)`` -> HWIO ``(kT, kF, I/g, O)``;
- ConvTranspose2d ``(I, O, kT, kF)`` -> HWIO ``(kT, kF, I, O)`` with the
  kernel reversed in both spatial dims (the flipped-kernel plain conv every
  path of the model runs);
- 1x1 convs -> ``(C_in, C_out)`` matrices;
- Conv1d depthwise ``(C, 1, k)`` -> ``(k, C)``;
- PReLU weight ``(1,)`` -> a scalar.

The loader takes the ``state_dict`` / ``model_state_dict`` / ``model`` key
variants and strips ``module.`` (DDP) prefixes; the BatchNorm step counters
are dropped, and any other tensor left unconsumed raises.
"""

from __future__ import annotations

import numpy as np
import torch

from gtcrn_micro_tpu_torch.io.params import params_from_numpy


def _load_state_dict(path: str) -> dict:
    # the reference's file also pickles its optimizer and scheduler objects
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt
    if isinstance(ckpt, dict):
        state = (ckpt.get("state_dict") or ckpt.get("model_state_dict")
                 or ckpt.get("model") or ckpt)
    return {k.removeprefix("module."): v.detach().cpu().numpy()
            for k, v in state.items() if torch.is_tensor(v)}


def _conv_oihw(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _deconv_iohw(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1].copy()  # (kT, kF, I, O), flipped


def _pw_conv(w: np.ndarray) -> np.ndarray:
    return w.reshape(w.shape[0], w.shape[1]).T.copy()  # (O, I, 1[, 1]) -> (I, O)


def _pw_deconv(w: np.ndarray) -> np.ndarray:
    return w.reshape(w.shape[0], w.shape[1]).copy()  # (I, O, 1, 1) -> (I, O)


def _bn(sd: dict, prefix: str) -> dict:
    return {"gamma": sd.pop(f"{prefix}.weight"), "beta": sd.pop(f"{prefix}.bias"),
            "running_mean": sd.pop(f"{prefix}.running_mean"),
            "running_var": sd.pop(f"{prefix}.running_var")}


def _prelu(sd: dict, key: str) -> dict:
    return {"alpha": sd.pop(key).reshape(())}


def _conv_block(sd: dict, prefix: str, deconv: bool, is_last: bool) -> dict:
    w = sd.pop(f"{prefix}.conv.weight")
    p = {"conv": {"w": _deconv_iohw(w) if deconv else _conv_oihw(w),
                  "b": sd.pop(f"{prefix}.conv.bias")},
         "bn": _bn(sd, f"{prefix}.bn")}
    if not is_last:
        p["act"] = _prelu(sd, f"{prefix}.act.weight")
    return p


def _gt_conv_block(sd: dict, prefix: str, deconv: bool) -> dict:
    pw = _pw_deconv if deconv else _pw_conv
    w_depth = sd.pop(f"{prefix}.depth_conv.weight")
    return {
        "point_conv1": {"w": pw(sd.pop(f"{prefix}.point_conv1.weight")),
                        "b": sd.pop(f"{prefix}.point_conv1.bias")},
        "point_bn1": _bn(sd, f"{prefix}.point_bn1"),
        "point_act": _prelu(sd, f"{prefix}.point_act.weight"),
        "depth_conv": {"w": _deconv_iohw(w_depth) if deconv else _conv_oihw(w_depth),
                       "b": sd.pop(f"{prefix}.depth_conv.bias")},
        "depth_bn": _bn(sd, f"{prefix}.depth_bn"),
        "depth_act": _prelu(sd, f"{prefix}.depth_act.weight"),
        "point_conv2": {"w": pw(sd.pop(f"{prefix}.point_conv2.weight")),
                        "b": sd.pop(f"{prefix}.point_conv2.bias")},
        "point_bn2": _bn(sd, f"{prefix}.point_bn2"),
        "tra": {
            "depth_w": sd.pop(f"{prefix}.tra.depth_conv.weight")[:, 0, :].T.copy(),
            "depth_b": sd.pop(f"{prefix}.tra.depth_conv.bias"),
            "point_w": _pw_conv(sd.pop(f"{prefix}.tra.point_conv.weight")),
            "point_b": sd.pop(f"{prefix}.tra.point_conv.bias"),
        },
    }


def _tcn(sd: dict, prefix: str) -> dict:
    return {
        "conv1": {"w": _pw_conv(sd.pop(f"{prefix}.conv1.weight")),
                  "b": sd.pop(f"{prefix}.conv1.bias")},
        "bn1": _bn(sd, f"{prefix}.bn1"),
        "act1": _prelu(sd, f"{prefix}.act1.weight"),
        "conv2": {"w": _conv_oihw(sd.pop(f"{prefix}.conv2.weight")),
                  "b": sd.pop(f"{prefix}.conv2.bias")},
        "bn2": _bn(sd, f"{prefix}.bn2"),
        "act2": _prelu(sd, f"{prefix}.act2.weight"),
        "conv3": {"w": _pw_conv(sd.pop(f"{prefix}.conv3.weight")),
                  "b": sd.pop(f"{prefix}.conv3.bias")},
        "bn3": _bn(sd, f"{prefix}.bn3"),
        "act3": _prelu(sd, f"{prefix}.act3.weight"),
    }


def import_reference_checkpoint(path: str, device=None) -> dict:
    """The params tree of ``init_params``'s form, float32 on ``device``
    (``None``: CUDA), from a reference GTCRN-Micro checkpoint.  Raises
    ``ValueError`` on any tensor left unconsumed and ``KeyError`` on one
    missing."""
    sd = _load_state_dict(path)
    for k in [k for k in sd if k.endswith("num_batches_tracked")]:
        sd.pop(k)

    params: dict = {
        "erb": {"bm_w": sd.pop("erb.erb_fc.weight").T.copy(),
                "bs_w": sd.pop("erb.ierb_fc.weight").T.copy()},
        "sfe": {"depth_conv": {"w": _conv_oihw(sd.pop("sfe.depth_conv.weight"))}},
    }
    enc = {f"en{i}": _conv_block(sd, f"encoder.en_convs.{i}", deconv=False, is_last=False)
           for i in (0, 1)}
    for i in (2, 3, 4):
        enc[f"en{i}"] = _gt_conv_block(sd, f"encoder.en_convs.{i}", deconv=False)
    params["encoder"] = enc
    for g in ("gtcn1", "gtcn2"):
        params[g] = {f"block{i}": _tcn(sd, f"{g}.blocks.{i}") for i in range(4)}
    dec = {f"de{i}": _gt_conv_block(sd, f"decoder.de_convs.{i}", deconv=True) for i in (0, 1, 2)}
    dec["de3"] = _conv_block(sd, "decoder.de_convs.3", deconv=True, is_last=False)
    dec["de4"] = _conv_block(sd, "decoder.de_convs.4", deconv=True, is_last=True)
    params["decoder"] = dec

    if sd:
        raise ValueError(f"unconsumed reference tensors: {sorted(sd)}")
    return params_from_numpy(params, device)
