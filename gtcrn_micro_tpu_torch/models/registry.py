"""Model registry, so configs can name models (the reference splats
``Model(**config["network_config"])``, train.py:84)."""

from __future__ import annotations

from typing import Callable

import torch

_REGISTRY: dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str, **kwargs):
    """The model ``name`` built from ``kwargs`` (its network config, plus
    ``dtype`` and ``device``), with zero weights: load them with
    ``load_params``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


@register_model("gtcrn_micro")
def _gtcrn_micro(n_fft: int = 512, hop_len: int = 256, win_len: int = 512,
                 dtype=torch.float32, device=None, **kw):
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, GTCRNMicroConfig

    return GTCRNMicro(GTCRNMicroConfig(n_fft=n_fft, hop_len=hop_len, win_len=win_len, **kw),
                      dtype=dtype, device=device)


@register_model("gtcrn")
def _gtcrn(n_fft: int = 512, hop_len: int = 256, win_len: int = 512,
           dtype=torch.float32, device=None, **kw):
    from gtcrn_micro_tpu_torch.models.gtcrn import GTCRN
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicroConfig

    return GTCRN(GTCRNMicroConfig(n_fft=n_fft, hop_len=hop_len, win_len=win_len, **kw),
                 dtype=dtype, device=device)


@register_model("tfgridnet")
def _tfgridnet(n_fft: int = 256, hop_len: int = 128, win_len: int | None = None,
               dtype=torch.float32, device=None, **kw):
    from gtcrn_micro_tpu_torch.models.tfgridnet import TFGridNet, TFGridNetConfig

    if win_len not in (None, n_fft):
        raise ValueError("TF-GridNet's window is n_fft long")
    return TFGridNet(TFGridNetConfig(n_fft=n_fft, hop_len=hop_len, **kw), dtype=dtype,
                     device=device)


@register_model("tflocoformer")
def _tflocoformer(n_fft: int = 256, hop_len: int = 128, win_len: int | None = None,
                  dtype=torch.float32, device=None, **kw):
    from gtcrn_micro_tpu_torch.models.tflocoformer import TFLocoformer, TFLocoformerConfig

    if win_len not in (None, n_fft):
        raise ValueError("TF-Locoformer's window is n_fft long")
    return TFLocoformer(TFLocoformerConfig(n_fft=n_fft, hop_len=hop_len, **kw), dtype=dtype,
                        device=device)
