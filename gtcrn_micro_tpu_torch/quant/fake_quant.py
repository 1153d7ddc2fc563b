"""Int8 fake-quantization primitives (PTQ simulation and QAT).

Counterpart of the JAX package's ``quant/fake_quant.py``: TFLite-compatible
affine quantization (the reference's full-integer int8 deployment,
scripts/onnx2tf.sh:50-64):

- activations: per-tensor (or per-lane) asymmetric, ``q = round(x / s) + z``;
- weights: per-channel symmetric int8, zero point 0.

Every step runs in float32 as in JAX: ``(hi - lo) / (qmax - qmin)``,
``round(qmin - lo / scale)``, ``amax / 127``; a float64 step would move a
scale by an ulp and whole values by a quantum.  ``torch.round`` rounds half
to even, as ``jnp.round`` does.  Divisions take the scale as a tensor on the
data's device: PyTorch's CUDA kernels turn a division by a host scalar into a
product with its reciprocal, which is not the same float32 number.

``fake_quant`` is a straight-through estimator, ``x + (y - x).detach()``: the
forward rounds through the integer grid, the backward passes gradients
unchanged, so the same function serves the PTQ simulation and QAT.
"""

from __future__ import annotations

import dataclasses

import torch

INT8_MIN, INT8_MAX = -128, 127
INT16_MIN, INT16_MAX = -32768, 32767


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 tensor on ``like``'s device (a divisor that the
    CUDA kernels do not turn into a reciprocal), filled there: a tensor
    copied from the host would wait for the device at every call."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class QParams:
    """Affine quantization parameters: ``x ~ (q - zero) * scale``.  ``scale``
    and ``zero`` are float32 tensors (0-d, per-lane or broadcastable
    per-channel); ``zero`` holds integer values."""

    scale: torch.Tensor
    zero: torch.Tensor
    qmin: int = INT8_MIN
    qmax: int = INT8_MAX

    def to(self, device) -> QParams:
        return dataclasses.replace(self, scale=self.scale.to(device), zero=self.zero.to(device))


def act_qparams(lo, hi, bits: int = 8) -> QParams:
    """Per-tensor (or per-lane, for vector ``lo``/``hi``) asymmetric params
    from an observed ``[lo, hi]`` range, nudged to include 0 so that zero
    padding stays exact.  ``bits`` 8 is full int8 (TFLite's default mode), 16
    the 16x8 mode (int16 activations, int8 weights)."""
    qmin, qmax = (INT8_MIN, INT8_MAX) if bits == 8 else (INT16_MIN, INT16_MAX)
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=lo.device)
    lo = torch.clamp_max(lo, 0.0)
    hi = torch.clamp_min(hi, 0.0)
    scale = torch.clamp_min((hi - lo) / _f32(qmax - qmin, lo), 1e-12)
    zero = torch.round(qmin - lo / scale)
    return QParams(scale=scale, zero=torch.clamp(zero, qmin, qmax), qmin=qmin, qmax=qmax)


def weight_qparams(w: torch.Tensor, channel_axis: int) -> QParams:
    """Per-channel symmetric int8 params (zero point 0), shaped to broadcast
    against ``w``."""
    axes = tuple(i for i in range(w.dim()) if i != channel_axis)
    amax = w.detach().abs().amax(dim=axes)
    scale = torch.clamp_min(amax / _f32(INT8_MAX, w), 1e-12)
    shape = [1] * w.dim()
    shape[channel_axis] = w.shape[channel_axis]
    return QParams(scale=scale.reshape(shape), zero=torch.zeros(shape, device=w.device))


def quantize(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    """Real quantization: float -> int8 (or int16 for 16-bit params)."""
    q = torch.round(x / qp.scale) + qp.zero
    dtype = torch.int8 if qp.qmax <= INT8_MAX else torch.int16
    return torch.clamp(q, qp.qmin, qp.qmax).to(dtype)


def dequantize(q: torch.Tensor, qp: QParams) -> torch.Tensor:
    return (q.float() - qp.zero) * qp.scale


def fake_quant(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    """Round ``x`` through the integer grid; straight-through gradient."""
    q = torch.clamp(torch.round(x / qp.scale) + qp.zero, qp.qmin, qp.qmax)
    y = (q - qp.zero) * qp.scale
    return x + (y - x).detach()


def saturation_fraction(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    """Fraction of values clipped by the integer range (parity diagnostics,
    reference utils/output_tests.py:116-135)."""
    q = torch.round(x / qp.scale) + qp.zero
    return ((q < qp.qmin) | (q > qp.qmax)).float().mean()
