"""GTCRN: parameter initialisation and the layered model (GTCRN-Micro's
configuration: the same STFT, ERB bands and channels).

GTCRN (Xiaobin Rong et al., "GTCRN: A Speech Enhancement Model Requiring
Ultralow Computational Resources", ICASSP 2024; Xiaobin-Rong/gtcrn,
``gtcrn.py``) is the model GTCRN-Micro was cut from.  It keeps the grouped
dual-path GRUs (``DPGRNN``) in the bottleneck and a GRU in every TRA gate,
where GTCRN-Micro has dilated TCNs and a causal conv.  Top-level graph:

    spec (B,F=257,T,2)
    -> [mag, real, imag] feature stack            (B,T,257,3)
    -> ERB band merge                             (B,T,129,3)
    -> SFE unfold (1, 3) over frequency           (B,T,129,9)
    -> Encoder (129->65->33 freq, 5 skips)        (B,T,33,16)
       en0 conv 9->16, en1 conv groups 2, GTConv d = 1, 2, 5
    -> DPGRNN x2 (intra BiGRU over F, inter GRU over T)
    -> Decoder (+skips, GTConv d = 5, 2, 1, de3 groups 2, 33->65->129)
    -> ERB band split, complex ratio mask         (B,F,T,2)

Departures from upstream, all of layout and none of numbers: activations
are (B, T, F, C) (upstream (B, C, T, F)); convs keep the port's HWIO
layout and the decoder's transposed convs are stored as flipped-kernel
plain convs (upstream ``ConvTranspose2d`` with time padding 2d over the
input left-padded by 2d frames is exactly a causal conv with the kernel
flipped in time and frequency); pointwise and linear weights are
``(C_in, C_out)``; the LayerNorms' affine leaves are ``gamma``/``beta``;
the GRUs keep torch's leaf names.  The ERB filters are GTCRN-Micro's (the
same 65 + 64 bands).

Streaming state (``init_state``): ring (or shift) caches of 2d frames for
each GTConv's depthwise conv (d in {1, 2, 5}: rings of 2, 4 and 10
frames), the hidden state of each TRA's GRU (B, 16) and of each DPGRNN's
inter GRU (B, 33, 16).  Rings of 10 frames do not divide 16, so the ring
counter runs modulo :data:`RING_PERIOD` = 80 = lcm(16, 2, 4, 10), and a
chunk whose slab crosses a ring's end is read and written by index
(``nn/core._window``).  Every op is causal, so T streamed frames from zero
state equal the offline forward over T frames.
"""

from __future__ import annotations

import math

import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.dsp.erb import ErbBands
from gtcrn_micro_tpu_torch.models.gtcrn_micro import (
    GTCRNMicro,
    GTCRNMicroConfig,
    _bn,
    _conv,
    _pointwise,
    _prelu,
    _to,
    _uniform,
)
from gtcrn_micro_tpu_torch.nn.blocks import DPGRNN, SFE, TRA, Decoder, Encoder
from gtcrn_micro_tpu_torch.nn.core import Ctx


# the ring counter's period: a multiple of 16 (the chunk sizes) and of every
# ring length 2d, d in {1, 2, 5}
RING_PERIOD = 80


def _gru(gen, i, h, bidirectional=False):
    """torch GRU default: U(-1/sqrt(H), 1/sqrt(H)) for every leaf."""
    b = 1.0 / math.sqrt(h)
    p = {}
    for sfx in ("", "_reverse") if bidirectional else ("",):
        p[f"weight_ih_l0{sfx}"] = _uniform(gen, (3 * h, i), b)
        p[f"weight_hh_l0{sfx}"] = _uniform(gen, (3 * h, h), b)
        p[f"bias_ih_l0{sfx}"] = _uniform(gen, (3 * h,), b)
        p[f"bias_hh_l0{sfx}"] = _uniform(gen, (3 * h,), b)
    return p


def _gtconv_block(gen, c=16, half=8):
    return {
        "point_conv1": _pointwise(gen, 3 * half, c),
        "point_bn1": _bn(c),
        "point_act": _prelu(),
        "depth_conv": _conv(gen, 3, 3, c, c, groups=c),
        "depth_bn": _bn(c),
        "depth_act": _prelu(),
        "point_conv2": _pointwise(gen, c, half),
        "point_bn2": _bn(half),
        "tra": {"att_gru": _gru(gen, half, 2 * half), "att_fc": _pointwise(gen, 2 * half, half)},
    }


def _conv_block(gen, c_in, c_out, groups=1, is_last=False):
    p = {"conv": _conv(gen, 1, 5, c_in, c_out, groups=groups), "bn": _bn(c_out)}
    if not is_last:
        p["act"] = _prelu()
    return p


def _dpgrnn(gen, c, width, hidden):
    ln = {"gamma": torch.ones(width, hidden), "beta": torch.zeros(width, hidden)}
    return {
        "intra_rnn": {f"rnn{g}": _gru(gen, c // 2, hidden // 4, bidirectional=True)
                      for g in (1, 2)},
        "intra_fc": _pointwise(gen, hidden, hidden),
        "intra_ln": {k: v.clone() for k, v in ln.items()},
        "inter_rnn": {f"rnn{g}": _gru(gen, c // 2, hidden // 2) for g in (1, 2)},
        "inter_fc": _pointwise(gen, hidden, hidden),
        "inter_ln": {k: v.clone() for k, v in ln.items()},
    }


def init_params(generator: torch.Generator | None = None, device=None,
                config: GTCRNMicroConfig = GTCRNMicroConfig()) -> dict:
    """Fresh GTCRN params (float32) drawn from ``generator`` on the CPU, then
    placed on ``device``: torch's default ranges, identity BatchNorm
    statistics and LayerNorm affines, PReLU 0.25, the frozen ERB filters."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    c = config
    C = c.channels
    params = {
        "erb": ErbBands(c.erb_subband_1, c.erb_subband_2, c.n_fft).init_params("cpu"),
        "encoder": {
            "en0": _conv_block(gen, 9, C),
            "en1": _conv_block(gen, C, C, groups=2),
            **{f"en{i}": _gtconv_block(gen) for i in (2, 3, 4)},
        },
        "dpgrnn1": _dpgrnn(gen, C, 33, 16),
        "dpgrnn2": _dpgrnn(gen, C, 33, 16),
        "decoder": {
            **{f"de{i}": _gtconv_block(gen) for i in (0, 1, 2)},
            "de3": _conv_block(gen, C, C, groups=2),
            "de4": _conv_block(gen, C, 2, is_last=True),
        },
    }
    return _to(params, dev)


class GTCRN(GTCRNMicro):
    """The layered GTCRN on one device, in one dtype: GTCRN-Micro's model
    (``apply``, ``init_state``/``step``, ``scan_frames``, a
    :class:`~gtcrn_micro_tpu_torch.serve.CohortServer` backend) over GTCRN's
    layers.  Offline, each GRU over time runs as one cuDNN call over the
    whole clip; a streamed step of one frame runs each as one GRU cell."""

    def _build(self, c) -> None:
        self.sfe = SFE(3)
        self.encoder = Encoder(in_ch=9, groups=2, dilations=(1, 2, 5), sfe=True, gate=TRA)
        self.dpgrnn1 = DPGRNN(c.channels, 33, 16)
        self.dpgrnn2 = DPGRNN(c.channels, 33, 16)
        self.decoder = Decoder(groups=2, dilations=(5, 2, 1), depth_groups=c.channels, sfe=True,
                               gate=TRA)

    def _middle(self, ctx: Ctx, feat):
        return self.dpgrnn2(ctx, self.dpgrnn1(ctx, feat))

    @staticmethod
    def _next_step(t, T: int):
        """The ring counter after a chunk of T frames, modulo
        :data:`RING_PERIOD`."""
        return (t + T) % RING_PERIOD
