"""Quantization of the layered model (the JAX package's ``quant``): fake
quantization, PTQ calibration, QAT and the parity report.  AdaRound, GPTQ
and mixed precision are not ported yet."""

from gtcrn_micro_tpu_torch.quant.fake_quant import (
    QParams,
    act_qparams,
    dequantize,
    fake_quant,
    quantize,
    saturation_fraction,
    weight_qparams,
)
from gtcrn_micro_tpu_torch.quant.ptq import (
    FakeQuantizer,
    FakeQuantizerV4,
    QuantizedModel,
    RangeObserver,
    make_quantized_model,
    observe_ranges,
)

__all__ = [
    "QParams", "act_qparams", "dequantize", "fake_quant", "quantize",
    "saturation_fraction", "weight_qparams", "FakeQuantizer", "FakeQuantizerV4",
    "QuantizedModel", "RangeObserver", "make_quantized_model", "observe_ranges",
]
