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
:class:`TRA`, :class:`GRNN` and :class:`DPGRNN`.  TF-GridNet's block
(ESPnet ``tfgridnet_separator.py``): :class:`GridNetBlock` with its norms
:class:`ChannelNorm`, :class:`FrameNorm` and :class:`MaskedGroupNorm`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as tF

from gtcrn_micro_tpu_torch.nn.core import (
    GRU,
    LSTM,
    BatchNorm,
    CausalConv2d,
    Ctx,
    Layer,
    LayerNorm,
    Pointwise,
    PReLU,
    TRALite,
    hidden_state,
    key_masked_attention,
    rope,
)
from gtcrn_micro_tpu_torch.ops import loco_ffn
from gtcrn_micro_tpu_torch.utils.profiling import count, span


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


# ---------------------------------------------------------------------------
# TF-GridNet (ESPnet espnet2/enh/separator/tfgridnet_separator.py)
# ---------------------------------------------------------------------------
#
# Activations are (B, T, F, D), channels last; every leaf keeps ESPnet's
# name and shape, so the model's state dict is ESPnet's separator's.  A
# frame's validity, where bucket padding follows a clip, is ``frames`` (B,)
# int64 on the device: each layer that reads across frames reads only the
# valid ones (see models/tfgridnet.py).

# rows of one intra LSTM call: the sub-band path runs over the B T frames in
# chunks of at most this many, so that its unfold, the LSTM's gates and
# outputs stay a few GB at 8,192-frame batches (the forward's peak is then
# 23 GB at four rows of 8,193 frames)
INTRA_ROWS = 8192


class ChannelNorm(nn.Module):
    """ESPnet's ``LayerNormalization4D``: LayerNorm over the channels at each
    (t, f), biased variance, affine ``gamma``, ``beta`` of shape (1, C, 1, 1)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1, 1))

    def forward(self, x):
        C = x.shape[-1]
        return tF.layer_norm(x, (C,), self.gamma.view(C), self.beta.view(C), self.eps)


class FrameNorm(nn.Module):
    """ESPnet's ``LayerNormalization4DCF``: LayerNorm over (C, F) of each
    frame, biased variance, affine of shape (1, C, 1, F); here over the last
    two axes (F, C) of (..., F, C)."""

    def __init__(self, channels: int, freqs: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(1, channels, 1, freqs))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1, freqs))

    def affine(self) -> tuple:
        """gamma, beta as (F, C)."""
        return self.gamma[0, :, 0].t(), self.beta[0, :, 0].t()

    def forward(self, x):
        g, b = self.affine()
        return tF.layer_norm(x, tuple(x.shape[-2:]), g.contiguous(), b.contiguous(), self.eps)


class MaskedGroupNorm(nn.GroupNorm):
    """``nn.GroupNorm(1, C)`` over (B, T, F, C) whose statistics (mean and
    biased variance over (T, F, C) of each row) cover only the row's first
    ``frames[b]`` frames; every frame past them is zero on the way out."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(1, channels, eps=eps)

    def forward(self, x, frames=None):
        B, T = x.shape[:2]
        if frames is None:
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            var = x.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        else:
            live = (torch.arange(T, device=x.device) < frames[:, None])[:, :, None, None]
            n = (frames * (x.shape[2] * x.shape[3])).to(x.dtype).view(B, 1, 1, 1)
            mean = torch.where(live, x, 0.0).sum(dim=(1, 2, 3), keepdim=True) / n
            var = torch.where(live, x - mean, 0.0).square().sum(dim=(1, 2, 3), keepdim=True) / n
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y if frames is None else torch.where(live, y, 0.0)


def transposed_conv1d(h, conv: nn.ConvTranspose1d):
    """``conv`` (stride 1) over h (N, W, C_in) channels last -> (N, W + k - 1,
    C_out): one GEMM to every tap's output, (N W, C_in) x (C_in, k C_out),
    then the k taps overlap-added."""
    C_in, C_out, k = conv.weight.shape
    N, W, _ = h.shape
    z = (h.reshape(N * W, C_in) @ conv.weight.permute(0, 2, 1).reshape(C_in, k * C_out))
    z = z.view(N, W, k, C_out)
    out = conv.bias.expand(N, W + k - 1, C_out).contiguous()
    for j in range(k):
        out[:, j : j + W] += z[:, :, j]
    return out


class GridNetBlock(nn.Module):
    """One TF-GridNet block (ESPnet ``GridNetBlock``, ``emb_hs`` 1) over
    (B, T, F, D):

    - intra (sub-band): ``intra_norm`` over D at each (t, f); an unfold of
      ``emb_ks`` neighbours over F (row ``c k + j`` is channel c at offset
      j); a BiLSTM over the F - k + 1 windows of each frame; ``intra_linear``
      (ConvTranspose1d 2H -> D, kernel k) back to F; residual;
    - inter (full-band): the same along T at each frequency with its own
      weights; with ``frames``, each row's BiLSTM runs over its own
      ``frames - k + 1`` windows (the backward direction from its own last
      one) and the windows past them are zero before ``inter_linear``;
    - attention: for each head l, Q_l, K_l = FrameNorm(PReLU(1x1 conv D ->
      E)) and V_l = FrameNorm(PReLU(1x1 conv D -> D/L)), each frame
      flattened to E F and D F / L values; softmax(Q K^T / sqrt(E F)) over
      every frame (with ``frames``, every valid frame) as one
      ``scaled_dot_product_attention``; the heads regrouped into D channels,
      ``attn_concat_proj`` (1x1 conv, PReLU, FrameNorm); residual.

    Under ``torch.profiler`` the three are the spans ``tfgridnet.intra``,
    ``tfgridnet.inter`` and ``tfgridnet.attn``."""

    def __init__(self, emb_dim: int, emb_ks: int, n_freqs: int, hidden: int, n_head: int,
                 approx_qk_dim: int):
        super().__init__()
        D, k = emb_dim, emb_ks
        self.emb_ks, self.n_head = k, n_head
        self.E = -(-approx_qk_dim // n_freqs)
        self.intra_norm = ChannelNorm(D)
        self.intra_rnn = LSTM(D * k, hidden, bidirectional=True)
        self.intra_linear = nn.ConvTranspose1d(2 * hidden, D, k)
        self.inter_norm = ChannelNorm(D)
        self.inter_rnn = LSTM(D * k, hidden, bidirectional=True)
        self.inter_linear = nn.ConvTranspose1d(2 * hidden, D, k)
        for i in range(n_head):
            for kind, c in (("Q", self.E), ("K", self.E), ("V", D // n_head)):
                self.add_module(f"attn_conv_{kind}_{i}", nn.Sequential(
                    nn.Conv2d(D, c, 1), nn.PReLU(), FrameNorm(c, n_freqs)))
        self.attn_concat_proj = nn.Sequential(nn.Conv2d(D, D, 1), nn.PReLU(),
                                              FrameNorm(D, n_freqs))

    def _unfold_rnn(self, ctx: Ctx, x, norm, rnn, linear, lengths=None):
        """norm, unfold, BiLSTM and transposed conv over sequences x (N, S, D)."""
        N, S, D = x.shape
        k = self.emb_ks
        win = norm(x).unfold(1, k, 1).reshape(N, S - k + 1, D * k)
        return transposed_conv1d(rnn(ctx, win, lengths), linear)

    def _heads(self, kind: str) -> list:
        return [getattr(self, f"attn_conv_{kind}_{i}") for i in range(self.n_head)]

    def _attention(self, x, frames=None):
        B, T, F, D = x.shape
        L = self.n_head
        convs = self._heads("Q") + self._heads("K") + self._heads("V")
        w = torch.cat([m[0].weight.flatten(1) for m in convs])  # (2 L E + D, D)
        b = torch.cat([m[0].bias for m in convs])
        # one PReLU slope per head and kind, spread over its channels
        slope = torch.cat([m[1].weight.expand(m[0].out_channels) for m in convs])
        z = tF.linear(x, w, b)
        z = torch.where(z >= 0, z, z * slope)
        qkv = []
        for part, heads in zip(z.split([L * self.E, L * self.E, D], dim=-1),
                               (self._heads("Q"), self._heads("K"), self._heads("V"))):
            c = part.shape[-1] // L
            h = part.view(B, T, F, L, c).permute(0, 3, 1, 2, 4)  # (B, L, T, F, c)
            h = tF.layer_norm(h, (F, c), eps=heads[0][2].eps)
            g, beta = zip(*(m[2].affine() for m in heads))
            h = h * torch.stack(g)[None, :, None] + torch.stack(beta)[None, :, None]
            qkv.append(h.reshape(B, L, T, F * c))
        q, k, v = qkv
        o = key_masked_attention(q, k, v, frames, scale=q.shape[-1] ** -0.5)  # (B, L, T, F D/L)
        o = o.view(B, L, T, F, D // L).permute(0, 2, 3, 1, 4).reshape(B, T, F, D)
        conv, act, norm = self.attn_concat_proj
        return norm(act(tF.linear(o, conv.weight.flatten(1), conv.bias)))

    def forward(self, ctx: Ctx, x, frames=None):
        """x (B, T, F, D), frames None or (B,) -> (B, T, F, D)."""
        B, T, F, D = x.shape
        with span("tfgridnet.intra"):
            rows = x.reshape(B * T, F, D)
            n = -(-rows.shape[0] // INTRA_ROWS)
            y = torch.cat([self._unfold_rnn(ctx, r, self.intra_norm, self.intra_rnn,
                                            self.intra_linear)
                           for r in rows.chunk(n)])
            x = x + y.view(B, T, F, D)
        with span("tfgridnet.inter"):
            windows = None if frames is None else (frames - self.emb_ks + 1).repeat_interleave(F)
            cols = x.transpose(1, 2).reshape(B * F, T, D)
            y = self._unfold_rnn(ctx, cols, self.inter_norm, self.inter_rnn, self.inter_linear,
                                 windows)
            x = x + y.view(B, F, T, D).transpose(1, 2)
        with span("tfgridnet.attn"):
            return x + self._attention(x, frames)


# -- TF-Locoformer (MERL tf-locoformer, ``TFLocoformerSeparator``) -----------
#
# Activations are (N, S, C) sequences, channels last: along frequency the
# B T frames' F bins, along time the B F bins' T frames.  Every leaf keeps
# MERL's name and shape.  Along time a sequence's validity is ``frames``
# (N,) int64 on the device (see models/tflocoformer.py).

# sequence positions one LocoformerBlock runs at once: a path runs over its
# sequences in chunks of about this many positions (an FFN's 512-wide
# windows and 768-wide conv output are then ~5 GB at most)
LOCO_POSITIONS = 1 << 20


class RMSGroupNorm(nn.Module):
    """MERL's ``RMSGroupNorm`` at each position: the C channels in ``groups``
    groups, each over its RMS plus ``eps`` (x_g / (||x_g|| / sqrt(C / G) +
    eps)), then times ``gamma`` (C); no bias.  Zero maps to zero."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.gamma = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        g = x.unflatten(-1, (self.groups, -1))
        rms = torch.linalg.vector_norm(g, dim=-1, keepdim=True) * g.shape[-1] ** -0.5
        return (g / (rms + self.eps)).flatten(-2) * self.gamma


class ConvSwiGLU(nn.Module):
    """MERL's ``SwiGLUConvDeconv1d`` at stride 1 over x (N, S, C): zero pad
    of k - 1 each side, ``conv1d`` (C -> 2 H, kernel k) as one GEMM over the
    S + k - 1 windows of k positions, u * SiLU(g) of its halves,
    ``deconv1d`` (H -> C, kernel k) by :func:`transposed_conv1d`, and the
    positions [k - 1, k - 1 + S) of its output."""

    def __init__(self, channels: int, hidden: int, kernel: int):
        super().__init__()
        self.conv1d = nn.Conv1d(channels, 2 * hidden, kernel)
        self.deconv1d = nn.ConvTranspose1d(hidden, channels, kernel)

    def forward(self, x):
        N, S, C = x.shape
        k = self.conv1d.kernel_size[0]
        xp = tF.pad(x, (0, 0, k - 1, k - 1))
        # window j is positions j ... j + k - 1 of the padded sequence, k C
        # values in a row of memory
        win = xp.as_strided((N, S + k - 1, k * C), (xp.stride(0), C, 1))
        w = self.conv1d.weight.permute(0, 2, 1).reshape(-1, k * C)  # (2 H, k C)
        u, g = tF.linear(win, w, self.conv1d.bias).chunk(2, dim=-1)
        return transposed_conv1d(u * tF.silu(g), self.deconv1d)[:, k - 1 : k - 1 + S]


class RoPESelfAttention(nn.Module):
    """MERL's ``MultiHeadSelfAttention`` over x (N, S, C): ``qkv`` (C -> 3 A,
    no bias) read as (S, 3, heads, A / heads); the queries and keys turned
    by the rotary table (:func:`nn.core.rope`); softmax(q k^T / sqrt(A /
    heads)) v in each head, with ``frames`` over each sequence's valid keys
    only; the heads concatenated into ``aggregate_heads`` (A -> C, no
    bias)."""

    def __init__(self, channels: int, attention_dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.qkv = nn.Linear(channels, 3 * attention_dim, bias=False)
        self.aggregate_heads = nn.Sequential(nn.Linear(attention_dim, channels, bias=False))

    def forward(self, x, table, frames=None):
        N, S, _ = x.shape
        qkv = tF.linear(x, self.qkv.weight).view(N, S, 3, self.n_heads, -1)
        q, k = rope(qkv[:, :, :2], table).unbind(2)  # (N, S, heads, E) each
        o = key_masked_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 qkv[:, :, 2].transpose(1, 2), frames)  # (N, heads, S, E)
        return tF.linear(o.transpose(1, 2).reshape(N, S, -1), self.aggregate_heads[0].weight)


class LocoformerBlock(nn.Module):
    """MERL's ``LocoformerBlock`` (macaron, two conv-SwiGLU FFNs) over x (N, S,
    C): x + FFN_1(norm(x)), then + MHSA(norm(x)), then + FFN_0(norm(x)),
    each norm an :class:`RMSGroupNorm` of its own.  With ``frames`` (N,) the
    residual stream is zero past each sequence's own positions at the input
    of every sub-layer and the attention's keys are its own positions: each
    sequence is computed as it would be alone at its own length.

    On a card, float32 with grad off at the published widths
    (``ops/loco_ffn.takes``), each FFN sub-layer, its norm, residual and mask
    included, is one launch of the kernel ``csrc/loco_ffn.cu``; ``launches``
    counts those launches, as does the counter ``tflocoformer.ffn_kernel``
    under tracing."""

    def __init__(self, channels: int, hidden: int, kernel: int, n_heads: int,
                 attention_dim: int, groups: int):
        super().__init__()
        self.ffn_norm = nn.ModuleList(RMSGroupNorm(groups, channels) for _ in range(2))
        self.ffn = nn.ModuleList(ConvSwiGLU(channels, hidden, kernel) for _ in range(2))
        self.attn_norm = RMSGroupNorm(groups, channels)
        self.attn = RoPESelfAttention(channels, attention_dim, n_heads)
        self.launches = 0

    def _ffn(self, i: int, x, frames, keep):
        """x + FFN_i(norm_i(x)), through ``keep`` for FFN_1."""
        norm, ffn = self.ffn_norm[i], self.ffn[i]
        if loco_ffn.routes(x, norm, ffn):
            self.launches += 1
            count("tflocoformer.ffn_kernel")
            return loco_ffn.run(x, norm, ffn, frames if i == 1 else None)
        y = x + ffn(norm(x))
        return keep(y) if i == 1 else y

    def forward(self, x, table, frames=None):
        """x (N, S, C), ``table`` the rotary table of S positions."""
        live = None
        if frames is not None:
            live = (torch.arange(x.shape[1], device=x.device) < frames[:, None])[:, :, None]

        def keep(y):
            return y if live is None else torch.where(live, y, 0.0)

        x = self._ffn(1, keep(x), frames, keep)
        x = keep(x + self.attn(self.attn_norm(x), table, frames))
        return self._ffn(0, x, frames, keep)


class TFLocoformerBlock(nn.Module):
    """MERL's ``TFLocoformerBlock`` at ``tf_order`` "ft" and stride 1 over x
    (B, T, F, C): ``freq_path``, a :class:`LocoformerBlock` over the F bins
    of every frame, then ``frame_path``, one over the T frames of every bin
    (with ``frames``, each row's own), each run over its sequences in chunks
    of about :data:`LOCO_POSITIONS` positions.  ``tables``: the rotary
    tables of F and of T positions.

    Under ``torch.profiler`` the two paths are the spans
    ``tflocoformer.freq`` and ``tflocoformer.time``."""

    def __init__(self, channels: int, hidden: int, kernel: int, n_heads: int,
                 attention_dim: int, groups: int):
        super().__init__()
        args = (channels, hidden, kernel, n_heads, attention_dim, groups)
        self.freq_path = LocoformerBlock(*args)
        self.frame_path = LocoformerBlock(*args)

    @staticmethod
    def _chunked(block, seqs, table, frames=None):
        n = -(-seqs.shape[0] * seqs.shape[1] // LOCO_POSITIONS)
        parts = seqs.chunk(n)
        lens = [None] * len(parts) if frames is None else frames.chunk(n)
        return torch.cat([block(s, table, f) for s, f in zip(parts, lens, strict=True)])

    def forward(self, ctx: Ctx, x, frames=None, *, tables):
        """x (B, T, F, C), frames None or (B,) -> (B, T, F, C)."""
        del ctx
        B, T, F, C = x.shape
        with span("tflocoformer.freq"):
            x = self._chunked(self.freq_path, x.reshape(B * T, F, C), tables[0]).view(B, T, F, C)
        with span("tflocoformer.time"):
            seq_frames = None if frames is None else frames.repeat_interleave(F)
            y = self._chunked(self.frame_path, x.transpose(1, 2).reshape(B * F, T, C), tables[1],
                              seq_frames)
            return y.view(B, F, T, C).transpose(1, 2).contiguous()
