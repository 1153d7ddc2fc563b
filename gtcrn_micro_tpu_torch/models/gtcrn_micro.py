"""GTCRN-Micro configuration and parameter initialisation.

``init_params`` returns the same nested dict as the JAX package's
``GTCRNMicro().init``: 342 leaves, 44,938 floats, with the same paths, shapes
and distributions (torch-default kaiming-uniform convs, identity BatchNorm
statistics, PReLU 0.25, the frozen ERB filters).  Weights keep the JAX
canonical layouts: convs are HWIO ``(kT, kF, C_in/groups, C_out)`` with
transposed convs stored as flipped-kernel plain convs, pointwise weights are
``(C_in, C_out)``.  The numbers differ from JAX's for the same seed
(``torch.Generator`` is not ``jax.random``); tests hand both packages the
same numpy params instead.

:class:`GTCRNMicro` is the layered model (``nn/core.py``, ``nn/blocks.py``):
the offline forward ``apply``, the streaming ``init_state``/``step`` (ring
state at chunks of T in {1, 2, 4, 8, 16}, shift state at any T), and a
:class:`~gtcrn_micro_tpu_torch.serve.CohortServer` backend.  Top-level graph
(reference gtcrn_micro/models/gtcrn_micro.py:485-532):

    spec (B,F=257,T,2)
    -> [mag, real, imag] feature stack            (B,T,257,3)
    -> ERB band merge                             (B,T,129,3)
    -> SFE-Lite depthwise freq conv               (B,T,129,3)
    -> Encoder (129->65->33 freq, 5 skips)        (B,T,33,16)
    -> GTCN x2 (8 dilated TCNs)                   (B,T,33,16)
    -> Decoder (+skips, 33->65->129)              (B,T,129,2)
    -> ERB band split, complex ratio mask         (B,F,T,2)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.dsp.erb import ErbBands
from gtcrn_micro_tpu_torch.nn.blocks import GTCN, Decoder, Encoder, SFELite
from gtcrn_micro_tpu_torch.nn.core import Ctx, exact_f32, name_paths


@dataclasses.dataclass(frozen=True)
class GTCRNMicroConfig:
    n_fft: int = 512
    hop_len: int = 256
    win_len: int = 512
    erb_subband_1: int = 65
    erb_subband_2: int = 64
    channels: int = 16

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) * bound


def _conv(gen, kT, kF, c_in, c_out, groups=1, bias=True):
    """torch Conv2d default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for w and b."""
    cin_g = c_in // groups
    bound = 1.0 / math.sqrt(kT * kF * cin_g)
    p = {"w": _uniform(gen, (kT, kF, cin_g, c_out), bound)}
    if bias:
        p["b"] = _uniform(gen, (c_out,), bound)
    return p


def _pointwise(gen, c_in, c_out):
    bound = 1.0 / math.sqrt(c_in)
    return {"w": _uniform(gen, (c_in, c_out), bound),
            "b": _uniform(gen, (c_out,), bound)}


def _bn(c):
    return {"gamma": torch.ones(c), "beta": torch.zeros(c),
            "running_mean": torch.zeros(c), "running_var": torch.ones(c)}


def _prelu():
    return {"alpha": torch.full((), 0.25)}


def _conv_block(gen, c_in, c_out, is_last=False):
    p = {"conv": _conv(gen, 1, 5, c_in, c_out), "bn": _bn(c_out)}
    if not is_last:
        p["act"] = _prelu()
    return p


def _gtconv_block(gen, deconv):
    c, half = 16, 8
    bound_d, bound_p = 1.0 / math.sqrt(3), 1.0 / math.sqrt(half)
    return {
        "point_conv1": _pointwise(gen, half, c),
        "point_bn1": _bn(c),
        "point_act": _prelu(),
        "depth_conv": _conv(gen, 3, 3, c, c, groups=1 if deconv else c),
        "depth_bn": _bn(c),
        "depth_act": _prelu(),
        "point_conv2": _pointwise(gen, c, half),
        "point_bn2": _bn(half),
        "tra": {
            "depth_w": _uniform(gen, (3, half), bound_d),
            "depth_b": _uniform(gen, (half,), bound_d),
            "point_w": _uniform(gen, (half, half), bound_p),
            "point_b": _uniform(gen, (half,), bound_p),
        },
    }


def _tcn_block(gen, c=16):
    return {
        "conv1": _pointwise(gen, c, c), "bn1": _bn(c), "act1": _prelu(),
        "conv2": _conv(gen, 3, 1, c, c, groups=c), "bn2": _bn(c), "act2": _prelu(),
        "conv3": _pointwise(gen, c, c), "bn3": _bn(c), "act3": _prelu(),
    }


def init_params(generator: torch.Generator | None = None, device=None,
                config: GTCRNMicroConfig = GTCRNMicroConfig()) -> dict:
    """Fresh GTCRN-Micro params (float32) drawn from ``generator`` on the CPU,
    then placed on ``device``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    c = config
    params = {
        "erb": ErbBands(c.erb_subband_1, c.erb_subband_2, c.n_fft).init_params("cpu"),
        "sfe": {"depth_conv": _conv(gen, 1, 3, 3, 3, groups=3, bias=False)},
        "encoder": {
            "en0": _conv_block(gen, 3, c.channels),
            "en1": _conv_block(gen, c.channels, c.channels),
            **{f"en{i}": _gtconv_block(gen, deconv=False) for i in (2, 3, 4)},
        },
        "gtcn1": {f"block{j}": _tcn_block(gen) for j in range(4)},
        "gtcn2": {f"block{j}": _tcn_block(gen) for j in range(4)},
        "decoder": {
            **{f"de{i}": _gtconv_block(gen, deconv=True) for i in (0, 1, 2)},
            "de3": _conv_block(gen, c.channels, c.channels),
            "de4": _conv_block(gen, c.channels, 2, is_last=True),
        },
    }
    return _to(params, dev)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def nest(flat: dict) -> dict:
    """``{"encoder.en0.conv.w": v}`` -> ``{"encoder": {"en0": {"conv": {"w": v}}}}``."""
    tree: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    """The inverse of :func:`nest`: nested dict -> dotted keys."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten(v, f"{prefix}{k}."))
        else:
            flat[prefix + k] = v
    return flat


# ---------------------------------------------------------------------------
# the layered model
# ---------------------------------------------------------------------------


class _Frozen(nn.Module):
    """Frozen tensors (the ERB filters), held as buffers."""

    def __init__(self, tensors: dict):
        super().__init__()
        for k, v in tensors.items():
            self.register_buffer(k, v)


class GTCRNMicro(nn.Module):
    """The layered GTCRN-Micro model on one device, in one dtype.

    The module tree is named like the JAX param tree and its tensors keep
    the JAX canonical layouts: trainable leaves are parameters, the ERB
    filters and the BatchNorm running statistics buffers.
    :meth:`from_params` loads the nested dict of :func:`init_params` (or a
    JAX tree as numpy arrays) cast to ``dtype``; :meth:`params` gives it
    back.

    ``apply`` is the offline forward (it shadows ``nn.Module.apply``);
    ``init_state``/``step`` stream over ring or shift state with the JAX
    state keys and shapes, updating the state tensors in place.  ``step``
    ignores its ``params`` argument, so the model is a
    :class:`~gtcrn_micro_tpu_torch.serve.CohortServer` backend: its state
    has the stream batch on axis 0 (``batch_axis``), and its ring steps take
    the chunk sizes ``chunk_sizes``.  Float32 runs without TF32 whatever
    the global flags say.
    """

    batch_axis = 0
    chunk_sizes = (1, 2, 4, 8, 16)

    def __init__(self, config: GTCRNMicroConfig = GTCRNMicroConfig(),
                 dtype=torch.float32, device=None):
        """A model of zero weights (load them with :meth:`load_params`)."""
        super().__init__()
        dev = resolve_device(device)
        c = config
        self._erb = ErbBands(c.erb_subband_1, c.erb_subband_2, c.n_fft)
        self.erb = _Frozen(self._erb.init_params("cpu"))
        self.sfe = SFELite(3)
        self.encoder = Encoder()
        self.gtcn1 = GTCN(c.channels)
        self.gtcn2 = GTCN(c.channels)
        self.decoder = Decoder()
        name_paths(self)
        self.to(dev, dtype)
        self.config, self.dtype, self.device = c, dtype, dev

    @classmethod
    def from_params(cls, params: dict, dtype=torch.float32, device=None,
                    config: GTCRNMicroConfig = GTCRNMicroConfig()) -> GTCRNMicro:
        model = cls(config, dtype, device)
        model.load_params(params)
        return model

    def load_params(self, params: dict) -> None:
        """Copy a nested param dict (tensors or array-likes) into the
        model, cast to its dtype; every leaf must be present with its
        shape, and no other."""
        flat = {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
                for k, v in flatten(params).items()}
        self.load_state_dict(flat, strict=True)

    def params(self) -> dict:
        """The nested param dict, JAX paths and layouts (tensors that share
        the model's storage)."""
        return nest(self.state_dict())

    # -- the shared graph ----------------------------------------------------

    def forward(self, spec, ctx: Ctx):
        """spec (B, F, T, 2) -> enhanced spec (B, F, T, 2), in the mode ``ctx``
        gives (the trainer calls it through ``torch.func.functional_call``)."""
        s = spec.transpose(1, 2)  # (B, T, F, 2)
        real, imag = s[..., 0], s[..., 1]
        mag = torch.sqrt(real * real + imag * imag + 1e-12)
        erb = {"bm_w": self.erb.bm_w, "bs_w": self.erb.bs_w}
        feat = torch.stack([self._erb.bm(erb, c) for c in (mag, real, imag)], dim=-1)
        feat = self.sfe(ctx, feat)
        feat, en_outs = self.encoder(ctx, feat)
        feat = self.gtcn2(ctx, self.gtcn1(ctx, feat))
        m = self.decoder(ctx, feat, en_outs)  # (B, T, 129, 2)
        m_r, m_i = (self._erb.bs(erb, m[..., i]) for i in (0, 1))
        out = torch.stack([real * m_r - imag * m_i, imag * m_r + real * m_i], dim=-1)
        return out.transpose(1, 2)

    def apply(self, spec, training: bool = False, quant=None):
        """Offline forward of spec (B, 257, T, 2), in the model's dtype on its
        device.  Returns the enhanced spec; in training mode ``(out, stats)``
        with the BatchNorm batch statistics by path.  Autograd follows the
        caller's grad mode.  ``quant``: a quantization hook (``quant/ptq.py``)."""
        ctx = Ctx(training=training, quant=quant)
        with exact_f32():
            out = self(spec, ctx)
        return (out, ctx.stats) if training else out

    # -- streaming -----------------------------------------------------------

    def init_state(self, batch: int, dtype=None, ring: bool = True,
                   l2_psum: bool = False, store_dtype=None) -> dict:
        """Zeroed streaming state for ``batch`` streams: a flat dict of
        ``(B, L, F, C)`` caches keyed by the JAX paths, in ``dtype`` (the
        model's by default).

        ``ring=True``: ring caches plus the integer ``step`` counter (T of
        every step a power of two <= 16, the same for the state's life); a
        0-d int64 tensor in its place also works, and is what an exported
        program carries (``io/export_program.py``).
        ``ring=False``: shift caches, any chunk size.  ``l2_psum`` (ring
        only): the 14 L == 2 convs carry their partial-output pairs
        ``psum_a``/``psum_b``.  ``store_dtype`` (ring only): the rings are
        stored in it (e.g. ``torch.float8_e4m3fn``) and cast on read."""
        dtype = dtype or self.dtype
        ctx = Ctx(initializing=True, ring=ring, l2_psum=ring and l2_psum,
                  store_dtype=store_dtype if ring else None)
        frame = torch.zeros((1, self.config.n_freqs, 1, 2), dtype=self.dtype,
                            device=self.device)
        with torch.no_grad(), exact_f32():
            self(frame, ctx)
        store = ctx.store_dtype or dtype
        state = {k: torch.zeros((batch,) + shape, device=self.device,
                                dtype=store if k.endswith("/ring") else dtype)
                 for k, shape in ctx.new_state.items()}
        if ring:
            # every ring length divides 16, so one mod-16 counter indexes all
            state["step"] = 0
        return state

    def step(self, params, state: dict, spec, quant=None):
        """One streaming step over a chunk: spec (B, 257, T, 2) -> (enhanced
        spec, the same state dict, updated in place).  ``params`` is
        ignored.  With ring state T must be a power of two <= 16.  ``quant``:
        a quantization hook, as for :meth:`apply`."""
        del params
        ring = "step" in state
        T = spec.shape[2]
        if ring and not (1 <= T <= 16 and T & (T - 1) == 0):
            raise ValueError(f"ring state needs a power-of-two chunk <= 16, got T={T}")
        # the cache strategy is encoded in the state's own keys
        l2_psum = ring and any(k.endswith("psum_a") for k in state)
        ctx = Ctx(state=state, ring=ring, step=state.get("step", 0), l2_psum=l2_psum,
                  quant=quant)
        with torch.no_grad(), exact_f32():
            out = self(spec, ctx)
        if ring:
            state["step"] = (state["step"] + T) & 15
        return out, state

    def scan_frames(self, params, state: dict, spec):
        """Stream a whole utterance one frame at a time: spec (B, F, T, 2)
        -> (enhanced spec, final state)."""
        return scan_stepper(self.step, params, state, spec)


def scan_stepper(step_fn, params, state: dict, spec):
    """Frame-by-frame loop of any step-protocol callable (``step(params,
    state, frame) -> (out, state)``) over spec (B, F, T, 2)."""
    outs = []
    for t in range(spec.shape[2]):
        y, state = step_fn(params, state, spec[:, :, t : t + 1])
        outs.append(y)
    return torch.cat(outs, dim=2), state


def main(argv=None) -> dict:
    """``python -m gtcrn_micro_tpu_torch.models.gtcrn_micro [--device cpu]``:
    the JAX package's demo of the model (complexity, causality, streaming
    against offline) on seed-0 weights.  Returns the three measurements."""
    import argparse

    from gtcrn_micro_tpu_torch.utils.complexity import model_complexity

    parser = argparse.ArgumentParser(description="complexity, causality and streaming demo")
    parser.add_argument("--device", default=None, help="default: cuda")
    ns = parser.parse_args(argv)
    dev = resolve_device(ns.device)
    model = GTCRNMicro.from_params(init_params(torch.Generator().manual_seed(0), device=dev),
                                   device=dev)
    n_params, n_macs = model_complexity(model)
    print(f"params: {n_params / 1e3:.2f} k   MACs/s audio: {n_macs / 1e6:.2f} M")

    # causality: identical prefixes -> identical outputs over the prefix
    rng = np.random.default_rng(0)
    a = rng.standard_normal((1, 257, 20, 2)).astype(np.float32)
    b = a.copy()
    b[:, :, 10:] = rng.standard_normal((1, 257, 10, 2))
    with torch.no_grad():
        ya = model.apply(torch.from_numpy(a).to(dev))
        yb = model.apply(torch.from_numpy(b).to(dev))
    pre = float((ya[:, :, :10] - yb[:, :, :10]).abs().max())
    post = float((ya[:, :, 10:] - yb[:, :, 10:]).abs().max())
    print(f"causality: prefix diff {pre:.2e} (==0), suffix diff {post:.3f} (>0)")

    # streaming (the ring step, frame by frame) == offline
    ys, _ = model.scan_frames(None, model.init_state(1), torch.from_numpy(a).to(dev))
    stream = float((ys - ya).abs().max())
    print(f"streaming vs offline: {stream:.2e}")
    return {"params": n_params, "macs": n_macs, "prefix_diff": pre, "suffix_diff": post,
            "stream_diff": stream}


if __name__ == "__main__":
    main()
