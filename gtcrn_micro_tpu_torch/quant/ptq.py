"""Post-training quantization: range observation -> int8 fake-quant model.

Counterpart of the JAX package's ``quant/ptq.py`` (reference equivalent:
onnx2tf full-integer PTQ with a calibration set, scripts/onnx2tf.sh +
utils/calibration_data.py):

1. :func:`observe_ranges` runs calibration specs through the layered model
   with a :class:`RangeObserver` as ``ctx.quant`` at every conv and matmul
   boundary (``nn/core.py``), and merges the per-path ranges over batches;
2. :func:`act_qparams` freezes the activation params, and the weight params
   (per-channel symmetric) follow the weights on every call;
3. :class:`QuantizedModel` runs the same model graph with fake-quant at
   every boundary, offline and streaming.  QAT is the trainer with the same
   quantizer as ``ctx.quant`` (straight-through gradients).

A hook receives the boundary's path (``encoder/en2/pw1/in``, the JAX scope
names: 59 activation paths) and the tensor.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gtcrn_micro_tpu_torch.nn.core import exact_f32
from gtcrn_micro_tpu_torch.quant.fake_quant import (
    QParams,
    act_qparams,
    fake_quant,
    weight_qparams,
)


def percentiles(x: torch.Tensor, ps: tuple[float, ...], per_channel: bool = False) -> list:
    """``jnp.percentile(x, p, axis)`` for each ``p`` of ``ps``, linear
    interpolation, with JAX's float32 index arithmetic (``q = p / 100``,
    ``q (n - 1)``, floor and ceil, weights ``q - low`` and ``1 - that``) and
    XLA's fused ``low * w_low + (high * w_high)`` (one rounding of the outer
    multiply-add, done here in float64).  Over all of ``x``, or with
    ``per_channel`` one value per lane of the last axis.  One sort serves
    every ``p``; ``torch.quantile`` would refuse more than 2^24 values."""
    v = x.detach().float()
    v = v.reshape(-1, v.shape[-1]).t() if per_channel else v.reshape(1, -1)
    v = torch.sort(v, dim=1).values
    n = v.shape[1]
    out = []
    for p in ps:
        q = np.float32(np.float32(p) / np.float32(100)) * np.float32(n - 1)
        lo, hi = np.floor(q), np.ceil(q)
        hw = np.float32(q - lo)
        lw = np.float32(1) - hw
        lo, hi = (int(min(max(i, 0), n - 1)) for i in (lo, hi))
        r = (v[:, lo].double() * float(lw) + (v[:, hi] * float(hw)).double()).float()
        out.append(r if per_channel else r[0])
    return out


class RangeObserver:
    """``ctx.quant`` hook that records per-path activation ranges.

    Ranges are percentile-clipped (default p99.99, as the reference's input
    calibration ``2 * p99.99 * 1.06``, utils/calibration_data.py:97-98): a
    hard min/max lets one outlier blow up the scale.  ``per_channel``: one
    ``[lo, hi]`` per lane of the last (channel) axis."""

    def __init__(self, percentile: float = 99.99, per_channel: bool = False):
        self.percentile = percentile
        self.per_channel = per_channel
        self.ranges: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def act(self, path: str, x):
        p = self.percentile
        self.ranges[path] = tuple(percentiles(x, (100.0 - p, p), self.per_channel))
        return x

    def weight(self, path: str, w, channel_axis: int):
        return w


class FakeQuantizer:
    """``ctx.quant`` hook applying fake-quant with frozen activation params
    (from calibration) and weight params computed from the current weights
    on every call (so QAT tracks the moving weights).  ``act_qp`` must be on
    the data's device."""

    def __init__(self, act_qp: dict[str, QParams]):
        self.act_qp = act_qp

    def act(self, path: str, x):
        qp = self.act_qp.get(path)
        if qp is None:
            raise KeyError(f"no activation qparams for {path}")
        return fake_quant(x, qp)

    def weight(self, path: str, w, channel_axis: int):
        return fake_quant(w, weight_qparams(w, channel_axis))


def _in_channel_axis(leaf: str, w, lanes: int) -> int:
    """Axis of ``w`` that contracts against the boundary's activation lanes
    (the channel axis), in the model layout: HWIO convs axis 2 (I) when
    mixing, axis 3 (O) when depthwise; pointwise ``(in, out)`` axis 0; the
    TRA ``depth_w`` ``(k, C)`` axis 1."""
    if w.dim() == 4:
        if w.shape[2] == lanes and w.shape[2] > 1:
            return 2
        if w.shape[2] == 1 and w.shape[3] == lanes:
            return 3
    elif w.dim() == 2:
        if leaf == "depth_w" and w.shape[1] == lanes:
            return 1
        if leaf != "depth_w" and w.shape[0] == lanes:
            return 0
    raise ValueError(f"cannot map {lanes} act lanes onto {leaf} {tuple(w.shape)}")


class FakeQuantizerV4(FakeQuantizer):
    """Integer-MAC per-channel simulation (GTM8 v4): per-lane activation
    scales folded into the weights, ``dequant(quant(w * s_in)) / s_in`` with
    per-out-channel params.  Each weight hook fires right after its
    boundary's act hook, so the pairing is positional."""

    def __init__(self, act_qp: dict[str, QParams]):
        super().__init__(act_qp)
        self._last_act: str | None = None

    def act(self, path: str, x):
        self._last_act = path
        return super().act(path, x)

    def weight(self, path: str, w, channel_axis: int):
        s = self.act_qp[self._last_act].scale.reshape(-1).float()
        if s.numel() == 1:
            sf = s[0]
        else:
            ax = _in_channel_axis(path.rpartition("/")[2], w, s.numel())
            shape = [1] * w.dim()
            shape[ax] = s.numel()
            sf = s.reshape(shape)
        wf = w * sf
        return fake_quant(wf, weight_qparams(wf, channel_axis)) / sf


class QuantizedModel(nn.Module):
    """The int8-simulated layered model: offline :meth:`apply` and the
    streaming :meth:`init_state` / :meth:`step` of ``model`` (a
    ``models.gtcrn_micro.GTCRNMicro``, which holds the float params) with a
    fake-quant hook at every boundary.  One graph definition: the offline,
    streaming and quantized paths cannot diverge.  ``v4`` simulates the
    full-integer per-channel deployment (:class:`FakeQuantizerV4`); it is
    fixed at construction.  The activation params move to the model's
    device and are held as buffers, so ``parameters()`` and ``buffers()``
    name every tensor the forward reads."""

    def __init__(self, model, act_qp: dict[str, QParams], v4: bool = False):
        super().__init__()
        self.model, self._v4 = model, v4
        self._bounds = [(path, qp.qmin, qp.qmax) for path, qp in act_qp.items()]
        for i, qp in enumerate(act_qp.values()):
            self.register_buffer(f"scale_{i}", qp.scale.to(model.device))
            self.register_buffer(f"zero_{i}", qp.zero.to(model.device))

    v4 = property(lambda self: self._v4)
    device = property(lambda self: self.model.device)
    dtype = property(lambda self: self.model.dtype)
    # what the offline entry point reads of a model (eval/infer.py)
    stft_config = property(lambda self: self.model.stft_config)
    window = property(lambda self: self.model.window)
    causal = property(lambda self: self.model.causal)
    scale_by_std = property(lambda self: self.model.scale_by_std)

    @property
    def act_qp(self) -> dict[str, QParams]:
        """The activation params by path, over the buffers."""
        return {path: QParams(getattr(self, f"scale_{i}"), getattr(self, f"zero_{i}"), lo, hi)
                for i, (path, lo, hi) in enumerate(self._bounds)}

    def _quantizer(self) -> FakeQuantizer:
        return (FakeQuantizerV4 if self.v4 else FakeQuantizer)(self.act_qp)

    def apply(self, spec):
        with torch.no_grad():
            return self.model.apply(spec, quant=self._quantizer())

    def init_state(self, batch: int, **opts) -> dict:
        return self.model.init_state(batch, **opts)

    def step(self, state: dict, spec):
        """The model's step (state updated in place)."""
        return self.model.step(state, spec, quant=self._quantizer())


def observe_ranges(model, calib_specs, batch_size: int = 8, percentile: float = 99.99,
                   per_channel: bool = False) -> dict:
    """Run calibration specs ``(N, F, T, 2)`` (numpy or a tensor) through
    ``model`` in batches on its device and return the merged per-path
    ranges: ``{path: (lo, hi)}`` as floats, or with ``per_channel`` as numpy
    vectors of the last axis's lanes."""
    specs = torch.as_tensor(calib_specs)
    merged: dict[str, tuple] = {}
    for i in range(0, specs.shape[0], batch_size):
        obs = RangeObserver(percentile, per_channel)
        spec = specs[i : i + batch_size].to(model.device, model.dtype)
        with torch.no_grad(), exact_f32():
            model.apply(spec, quant=obs)
        for path, (lo, hi) in obs.ranges.items():
            lo, hi = lo.cpu().numpy(), hi.cpu().numpy()
            if path in merged:
                merged[path] = (np.minimum(merged[path][0], lo), np.maximum(merged[path][1], hi))
            else:
                merged[path] = (lo, hi)
    if per_channel:
        return merged
    return {p: (float(lo), float(hi)) for p, (lo, hi) in merged.items()}


def qparams_from_ranges(ranges: dict, act_bits: int = 8, device=None) -> dict[str, QParams]:
    """Frozen activation params from :func:`observe_ranges`'s ranges."""
    return {p: act_qparams(np.float32(lo), np.float32(hi), act_bits).to(device or "cpu")
            for p, (lo, hi) in ranges.items()}


def make_quantized_model(model, calib_specs, batch_size: int = 8, percentile: float = 99.99,
                         act_bits: int = 8, per_channel_acts: bool = False,
                         v4: bool = False) -> QuantizedModel:
    """One-shot PTQ: observe ranges, freeze the activation params, return the
    :class:`QuantizedModel`.  ``act_bits`` 8 is full int8 (the reference
    artifact's format), 16 the 16x8 mode; ``per_channel_acts``: per-lane
    activation scales; ``v4``: the full-integer per-channel simulation."""
    ranges = observe_ranges(model, calib_specs, batch_size, percentile,
                            per_channel=per_channel_acts)
    return QuantizedModel(model=model, act_qp=qparams_from_ranges(ranges, act_bits), v4=v4)
