"""Quantization of the layered model (the JAX package's ``quant``): fake
quantization, PTQ calibration, QAT, the parity report, AdaRound with learned
activation scales, GPTQ and mixed 16/8 activation precision."""

from gtcrn_micro_tpu_torch.quant.adaround import (
    AdaRoundQuantizer,
    adaround_optimize,
    bias_refine,
    load_act_qp,
)
from gtcrn_micro_tpu_torch.quant.fake_quant import (
    QParams,
    act_qparams,
    dequantize,
    fake_quant,
    quantize,
    saturation_fraction,
    weight_qparams,
)
from gtcrn_micro_tpu_torch.quant.mixed import compose_act_qp, greedy_lift
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
    "AdaRoundQuantizer", "adaround_optimize", "bias_refine", "load_act_qp", "compose_act_qp",
    "greedy_lift",
]
