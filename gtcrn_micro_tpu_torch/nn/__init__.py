"""Layers and blocks of the layered GTCRN-Micro and GTCRN models (the JAX
package's ``nn``, and GTCRN's recurrent layers)."""

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
    GTConvBlock,
    SFELite,
)
from gtcrn_micro_tpu_torch.nn.core import (
    GRU,
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
    "DPGRNN", "GRNN", "GRU", "GTCN", "SFE", "TCN", "TRA", "BatchNorm", "CausalConv2d",
    "ConvBlock", "Ctx", "Decoder", "Encoder", "GTConvBlock", "LayerNorm", "PReLU",
    "Pointwise", "SFELite", "TRALite", "exact_f32",
]
