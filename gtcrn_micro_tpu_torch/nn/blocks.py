"""GTCRN-Micro building blocks, one definition for offline and streaming.

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
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gtcrn_micro_tpu_torch.nn.core import (
    BatchNorm,
    CausalConv2d,
    Ctx,
    Pointwise,
    PReLU,
    TRALite,
)


class SFELite(nn.Module):
    """Depthwise (1, 3) frequency conv, groups = C, no bias (subband
    feature extraction)."""

    def __init__(self, channels: int = 3):
        super().__init__()
        self.depth_conv = CausalConv2d(channels, channels, (1, 3), freq_pad=1,
                                       groups=channels, bias=False)

    def forward(self, ctx: Ctx, x):
        return self.depth_conv(ctx, x)


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
    a causal (3, 3) conv (groups 16 in the encoder, 1 in the decoder), and
    pointwise H -> C/2 with the TRA gate, then interleaves with the second
    half: ``out[2c] = h[c]``, ``out[2c + 1] = x2[c]`` (reference :222-253).
    """

    def __init__(self, c_in: int, hidden: int, kernel: tuple[int, int],
                 freq_pad: int, dilation: tuple[int, int] = (1, 1),
                 use_deconv: bool = False):
        super().__init__()
        half = c_in // 2
        self.point_conv1 = Pointwise(half, hidden, quant_name="pw1")
        self.point_bn1 = BatchNorm(hidden)
        self.point_act = PReLU()
        self.depth_conv = CausalConv2d(hidden, hidden, kernel, freq_pad=freq_pad,
                                       dilation=dilation,
                                       groups=1 if use_deconv else 16)
        self.depth_bn = BatchNorm(hidden)
        self.depth_act = PReLU()
        self.point_conv2 = Pointwise(hidden, half, quant_name="pw2")
        self.point_bn2 = BatchNorm(half)
        self.tra = TRALite(half)

    def forward(self, ctx: Ctx, x):
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        h = self.point_act(self.point_bn1(ctx, self.point_conv1(ctx, x1)))
        h = self.depth_act(self.depth_bn(ctx, self.depth_conv(ctx, h)))
        h = self.point_bn2(ctx, self.point_conv2(ctx, h))
        h = self.tra(ctx, h)
        return torch.stack([h, x2], dim=-1).flatten(-2)


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
    """Two strided frequency ConvBlocks (129 -> 65 -> 33) and three
    GTConvBlocks; returns the output and the five skips."""

    def __init__(self):
        super().__init__()
        self.en0 = ConvBlock(3, 16, (1, 5), freq_stride=2, freq_pad=2)
        self.en1 = ConvBlock(16, 16, (1, 5), freq_stride=2, freq_pad=2)
        self.en2 = GTConvBlock(16, 16, (3, 3), freq_pad=1)
        self.en3 = GTConvBlock(16, 16, (3, 3), freq_pad=1)
        self.en4 = GTConvBlock(16, 16, (3, 3), freq_pad=1)

    def forward(self, ctx: Ctx, x):
        outs = []
        for layer in self.children():
            x = layer(ctx, x)
            outs.append(x)
        return x, outs


class Decoder(nn.Module):
    """Mirror of the encoder with additive skips and transposed frequency
    convs (33 -> 65 -> 129)."""

    def __init__(self):
        super().__init__()
        self.de0 = GTConvBlock(16, 16, (3, 3), freq_pad=1, use_deconv=True)
        self.de1 = GTConvBlock(16, 16, (3, 3), freq_pad=1, use_deconv=True)
        self.de2 = GTConvBlock(16, 16, (3, 3), freq_pad=1, use_deconv=True)
        self.de3 = ConvBlock(16, 16, (1, 5), freq_stride=2, freq_pad=2, use_deconv=True)
        self.de4 = ConvBlock(16, 2, (1, 5), freq_stride=2, freq_pad=2, use_deconv=True,
                             is_last=True)

    def forward(self, ctx: Ctx, x, en_outs):
        for i, layer in enumerate(self.children()):
            x = layer(ctx, x + en_outs[len(en_outs) - 1 - i])
        return x
