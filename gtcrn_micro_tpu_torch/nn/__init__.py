"""Layers and blocks of the layered GTCRN-Micro model (the JAX package's
``nn``)."""

from gtcrn_micro_tpu_torch.nn.blocks import (
    GTCN,
    TCN,
    ConvBlock,
    Decoder,
    Encoder,
    GTConvBlock,
    SFELite,
)
from gtcrn_micro_tpu_torch.nn.core import (
    BatchNorm,
    CausalConv2d,
    Ctx,
    Pointwise,
    PReLU,
    TRALite,
    exact_f32,
)

__all__ = [
    "GTCN", "TCN", "BatchNorm", "CausalConv2d", "ConvBlock", "Ctx", "Decoder",
    "Encoder", "GTConvBlock", "PReLU", "Pointwise", "SFELite", "TRALite",
    "exact_f32",
]
