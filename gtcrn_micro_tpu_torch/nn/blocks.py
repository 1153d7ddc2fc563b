"""GTCRN-Micro and GTCRN building blocks, one definition for offline and
streaming.

Counterpart of the JAX package's ``nn/blocks.py``; submodule names are the
JAX param names, so a module's path in the tree is its param path.  The
pointwise layers also carry their JAX scope name (``pw1``, ``pw2``, ``pw3``),
the name of their quantization boundary.
Reference geometry:

- ConvBlock:     gtcrn_micro/models/gtcrn_micro.py:142-164
- GTConvBlock:   gtcrn_micro/models/gtcrn_micro.py:167-253
- TCN / GTCN:    gtcrn_micro/models/gtcrn_micro.py:256-336
- SFE_Lite:      gtcrn_micro/models/gtcrn_micro.py:77-90
- Encoder:       gtcrn_micro/models/gtcrn_micro.py:339-402
- Decoder:       gtcrn_micro/models/gtcrn_micro.py:405-469

GTCRN (Xiaobin-Rong/gtcrn, ``gtcrn.py``), of which GTCRN-Micro is the cut:
the same ConvBlock, GTConvBlock, Encoder and Decoder at other parameters
(``sfe``, ``depth_groups``, ``gate``, ``dilations``, ``in_ch``,
``groups``; ``models/gtcrn.py`` passes GTCRN's), and :class:`SFE`,
:class:`TRA`, :class:`GRNN` and :class:`DPGRNN`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as tF

from gtcrn_micro_tpu_torch.nn.core import (
    GRU,
    BatchNorm,
    CausalConv2d,
    Ctx,
    Layer,
    LayerNorm,
    Pointwise,
    PReLU,
    TRALite,
    hidden_state,
)
from gtcrn_micro_tpu_torch.utils.profiling import span


class SFELite(nn.Module):
    """Depthwise (1, 3) frequency conv, groups = C, no bias (subband
    feature extraction)."""

    def __init__(self, channels: int = 3):
        super().__init__()
        self.depth_conv = CausalConv2d(channels, channels, (1, 3), freq_pad=1,
                                       groups=channels, bias=False)

    def forward(self, ctx: Ctx, x):
        return self.depth_conv(ctx, x)


class SFE(nn.Module):
    """GTCRN's subband feature extraction (``gtcrn.py`` ``SFE``): an unfold
    of (1, 3) over frequency with one zero of padding on each side, no
    weights; output channel ``3 c + k`` holds ``x[..., f + k - 1, c]``."""

    def __init__(self, kernel: int = 3):
        super().__init__()
        self.kernel = kernel

    def forward(self, ctx: Ctx, x):
        del ctx
        F, p = x.shape[2], (self.kernel - 1) // 2
        xp = tF.pad(x, (0, 0, p, p))
        return torch.stack([xp[:, :, k : k + F] for k in range(self.kernel)],
                           dim=-1).flatten(-2)


class TRA(Layer):
    """GTCRN's temporal recurrent attention (``gtcrn.py`` ``TRA``): the
    frame energy ``e = mean(x * x)`` over frequency (B, T, C) runs through
    ``att_gru`` (GRU C -> 2C over time from a zero state), ``att_fc`` (2C ->
    C) and a sigmoid, the gate ``g``; the output is ``x * g`` broadcast over
    frequency.  A stream carries the GRU's hidden state (B, 2C).  Under
    ``torch.profiler`` it is the span ``gtcrn.tra``."""

    def __init__(self, channels: int):
        super().__init__()
        self.att_gru = GRU(channels, 2 * channels)
        self.att_fc = Pointwise(channels * 2, channels)

    def forward(self, ctx: Ctx, x):
        with span("gtcrn.tra"):
            e = (x * x).mean(dim=2)  # (B, T, C)
            h = hidden_state(ctx, self, (self.att_gru.hidden_size,))
            a, hn = self.att_gru(ctx, e, h)
            if h is not None:
                h.copy_(hn)
            g = torch.sigmoid(self.att_fc(ctx, a))
            return x * g[:, :, None, :]


class GRNN(nn.Module):
    """Grouped GRU (``gtcrn.py`` ``GRNN``): the channels and the hidden state
    split in halves, ``rnn1`` runs the first and ``rnn2`` the second, and
    their outputs and last states are joined again."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = False):
        super().__init__()
        self.rnn1 = GRU(input_size // 2, hidden_size // 2, bidirectional)
        self.rnn2 = GRU(input_size // 2, hidden_size // 2, bidirectional)

    def forward(self, ctx: Ctx, x, h=None):
        """x (N, S, I), h (N, H) or None -> (y (N, S, D H), last h (N, H))."""
        x1, x2 = x.chunk(2, dim=-1)
        h1, h2 = (None, None) if h is None else h.chunk(2, dim=-1)
        y1, h1 = self.rnn1(ctx, x1, h1)
        y2, h2 = self.rnn2(ctx, x2, h2)
        return torch.cat([y1, y2], dim=-1), torch.cat([h1, h2], dim=-1)


class DPGRNN(Layer):
    """Grouped dual-path GRU block (``gtcrn.py`` ``DPGRNN``) over (B, T, F, C)
    with F = ``width``:

    - intra: a grouped bidirectional GRU over frequency inside each frame,
      ``intra_fc``, LayerNorm over (F, C); ``x1 = x + that``;
    - inter: a grouped GRU over time for each frequency, ``inter_fc``,
      LayerNorm over (F, C); the output is ``x1 + that``.

    A stream carries the inter GRU's hidden state (B, F, C) (state key
    ``<path>/h``); the intra path keeps none.  Under
    ``torch.profiler`` the halves are the spans ``gtcrn.intra`` and
    ``gtcrn.inter``."""

    def __init__(self, channels: int, width: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.intra_rnn = GRNN(channels, hidden // 2, bidirectional=True)
        self.intra_fc = Pointwise(hidden, hidden)
        self.intra_ln = LayerNorm((width, hidden), eps=1e-8)
        self.inter_rnn = GRNN(channels, hidden)
        self.inter_fc = Pointwise(hidden, hidden)
        self.inter_ln = LayerNorm((width, hidden), eps=1e-8)

    def forward(self, ctx: Ctx, x):
        B, T, F, C = x.shape
        with span("gtcrn.intra"):
            y, _ = self.intra_rnn(ctx, x.reshape(B * T, F, C))
            x = x + self.intra_ln(self.intra_fc(ctx, y).reshape(B, T, F, self.hidden))
        with span("gtcrn.inter"):
            h = hidden_state(ctx, self, (F, self.hidden))
            xt = x.transpose(1, 2).reshape(B * F, T, C)
            y, hn = self.inter_rnn(ctx, xt, None if h is None else h.reshape(B * F, self.hidden))
            if h is not None:
                h.copy_(hn.reshape(B, F, self.hidden))
            y = self.inter_fc(ctx, y).reshape(B, F, T, self.hidden).transpose(1, 2)
            return x + self.inter_ln(y)


class ConvBlock(nn.Module):
    """Conv or transposed conv, BatchNorm, then PReLU (tanh on the mask
    layer)."""

    def __init__(self, c_in: int, c_out: int, kernel: tuple[int, int],
                 freq_stride: int = 1, freq_pad: int = 0, groups: int = 1,
                 use_deconv: bool = False, is_last: bool = False):
        super().__init__()
        self.conv = CausalConv2d(c_in, c_out, kernel,
                                 freq_stride=1 if use_deconv else freq_stride,
                                 freq_pad=freq_pad, groups=groups,
                                 freq_up=freq_stride if use_deconv else 1)
        self.bn = BatchNorm(c_out)
        self.act = None if is_last else PReLU()

    def forward(self, ctx: Ctx, x):
        h = self.bn(ctx, self.conv(ctx, x))
        return torch.tanh(h) if self.act is None else self.act(h)


class GTConvBlock(nn.Module):
    """Grouped temporal conv block with TRA gating and channel shuffle.

    The input's channels split in halves; the first runs pointwise C/2 -> H,
    a causal (3, 3) conv of ``depth_groups`` groups (GTCRN-Micro: 16 in the
    encoder, 1 in the decoder) at time ``dilation``, and pointwise H -> C/2
    with the ``gate`` (a layer of C/2 channels: :class:`TRALite`, or GTCRN's
    GRU-gated :class:`TRA`), then interleaves with the second half:
    ``out[2c] = h[c]``, ``out[2c + 1] = x2[c]`` (reference :222-253).  With
    ``sfe`` the first half runs through :class:`SFE` first (GTCRN), so the
    first pointwise takes 3C/2 channels.
    """

    def __init__(self, c_in: int, hidden: int, kernel: tuple[int, int],
                 freq_pad: int, dilation: tuple[int, int] = (1, 1),
                 depth_groups: int = 16, sfe: bool = False, gate=TRALite):
        super().__init__()
        half = c_in // 2
        self.sfe = SFE(3) if sfe else None
        self.point_conv1 = Pointwise(3 * half if sfe else half, hidden, quant_name="pw1")
        self.point_bn1 = BatchNorm(hidden)
        self.point_act = PReLU()
        self.depth_conv = CausalConv2d(hidden, hidden, kernel, freq_pad=freq_pad,
                                       dilation=dilation, groups=depth_groups)
        self.depth_bn = BatchNorm(hidden)
        self.depth_act = PReLU()
        self.point_conv2 = Pointwise(hidden, half, quant_name="pw2")
        self.point_bn2 = BatchNorm(half)
        self.tra = gate(half)

    def forward(self, ctx: Ctx, x):
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        if self.sfe is not None:
            x1 = self.sfe(ctx, x1)
        h = self.point_act(self.point_bn1(ctx, self.point_conv1(ctx, x1)))
        h = self.depth_act(self.depth_bn(ctx, self.depth_conv(ctx, h)))
        h = self.point_bn2(ctx, self.point_conv2(ctx, h))
        h = self.tra(ctx, h)
        return self.shuffle(h, x2)

    @staticmethod
    def shuffle(x1, x2):
        """Interleave channels: ``out[..., 2c] = x1[..., c]``, ``out[..., 2c + 1]
        = x2[..., c]``, as one copy (JAX's ``GTConvBlock.shuffle`` takes two
        one-hot products; ``scripts/ablate_shuffle.py`` swaps this seam)."""
        return torch.stack([x1, x2], dim=-1).flatten(-2)


class TCN(nn.Module):
    """Residual temporal conv block: 1x1 -> causal depthwise (k, 1) dilated
    -> 1x1, PReLU after the residual sum."""

    def __init__(self, channels: int, kernel: int = 3, dilation: int = 1):
        super().__init__()
        c = channels
        self.conv1 = Pointwise(c, c, quant_name="pw1")
        self.bn1 = BatchNorm(c)
        self.act1 = PReLU()
        self.conv2 = CausalConv2d(c, c, (kernel, 1), dilation=(dilation, 1), groups=c)
        self.bn2 = BatchNorm(c)
        self.act2 = PReLU()
        self.conv3 = Pointwise(c, c, quant_name="pw3")
        self.bn3 = BatchNorm(c)
        self.act3 = PReLU()

    def forward(self, ctx: Ctx, x):
        y = self.act1(self.bn1(ctx, self.conv1(ctx, x)))
        y = self.act2(self.bn2(ctx, self.conv2(ctx, y)))
        y = self.bn3(ctx, self.conv3(ctx, y))
        return self.act3(y + x)


class GTCN(nn.Module):
    """``block0`` ... ``block{n-1}``: TCNs with dilations 1, 2, 4, 8 (the
    model family has no RNN, reference :313-336)."""

    def __init__(self, channels: int, n_layers: int = 4, kernel: int = 3,
                 dilation_growth: int = 2):
        super().__init__()
        for i in range(n_layers):
            self.add_module(f"block{i}", TCN(channels, kernel, dilation_growth ** i))

    def forward(self, ctx: Ctx, x):
        for block in self.children():
            x = block(ctx, x)
        return x


class Encoder(nn.Module):
    """Two strided frequency ConvBlocks (129 -> 65 -> 33; ``in_ch`` input
    channels, the second of ``groups`` groups) and three GTConvBlocks at time
    ``dilations``, each with ``sfe`` and ``gate``; returns the output and the
    five skips.  The defaults are GTCRN-Micro's."""

    def __init__(self, in_ch: int = 3, groups: int = 1, dilations=(1, 1, 1),
                 sfe: bool = False, gate=TRALite):
        super().__init__()
        self.en0 = ConvBlock(in_ch, 16, (1, 5), freq_stride=2, freq_pad=2)
        self.en1 = ConvBlock(16, 16, (1, 5), freq_stride=2, freq_pad=2, groups=groups)
        for i, d in enumerate(dilations):
            self.add_module(f"en{i + 2}", GTConvBlock(16, 16, (3, 3), freq_pad=1,
                                                      dilation=(d, 1), sfe=sfe, gate=gate))

    def forward(self, ctx: Ctx, x):
        outs = []
        for layer in self.children():
            x = layer(ctx, x)
            outs.append(x)
        return x, outs


class Decoder(nn.Module):
    """Mirror of the encoder with additive skips: three GTConvBlocks at time
    ``dilations`` (their 3x3 convs of ``depth_groups`` groups, each with
    ``sfe`` and ``gate``), then transposed frequency convs (33 -> 65 -> 129;
    the first of ``groups`` groups).  The defaults are GTCRN-Micro's."""

    def __init__(self, groups: int = 1, dilations=(1, 1, 1), depth_groups: int = 1,
                 sfe: bool = False, gate=TRALite):
        super().__init__()
        for i, d in enumerate(dilations):
            self.add_module(f"de{i}", GTConvBlock(16, 16, (3, 3), freq_pad=1, dilation=(d, 1),
                                                  depth_groups=depth_groups, sfe=sfe, gate=gate))
        self.de3 = ConvBlock(16, 16, (1, 5), freq_stride=2, freq_pad=2, groups=groups,
                             use_deconv=True)
        self.de4 = ConvBlock(16, 2, (1, 5), freq_stride=2, freq_pad=2, use_deconv=True,
                             is_last=True)

    def forward(self, ctx: Ctx, x, en_outs):
        for i, layer in enumerate(self.children()):
            x = layer(ctx, x + en_outs[len(en_outs) - 1 - i])
        return x
