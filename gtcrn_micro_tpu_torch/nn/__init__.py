"""Layers and blocks of the layered GTCRN-Micro, GTCRN and TF-GridNet models
(the JAX package's ``nn``, GTCRN's recurrent layers, TF-GridNet's block)."""

from gtcrn_micro_tpu_torch.nn.blocks import (
    DPGRNN,
    GRNN,
    GTCN,
    SFE,
    TCN,
    TRA,
    ConvBlock,
    Decoder,
    Encoder,
    GridNetBlock,
    GTConvBlock,
    SFELite,
)
from gtcrn_micro_tpu_torch.nn.core import (
    GRU,
    LSTM,
    BatchNorm,
    CausalConv2d,
    Ctx,
    LayerNorm,
    Pointwise,
    PReLU,
    TRALite,
    exact_f32,
)

__all__ = [
    "DPGRNN", "GRNN", "GRU", "GTCN", "LSTM", "SFE", "TCN", "TRA", "BatchNorm", "CausalConv2d",
    "ConvBlock", "Ctx", "Decoder", "Encoder", "GridNetBlock", "GTConvBlock", "LayerNorm", "PReLU",
    "Pointwise", "SFELite", "TRALite", "exact_f32",
]
