"""TF-GridNet on the port's offline path: the layered model.

TF-GridNet (Z.-Q. Wang, S. Cornell, S. Choi, Y. Masuyama, R. Scheibler,
Y. Chang, S. Watanabe, "TF-GridNet: Integrating Full- and Sub-Band Modeling
for Speech Separation", IEEE/ACM TASLP 2023, arXiv:2211.12433; ESPnet
``espnet2/enh/separator/tfgridnet_separator.py``, class ``TFGridNet``) maps
the complex spectrum of a mixture to the complex spectrum of each source.
Top-level graph, at the class's defaults with one source:

    waveform / std (unbiased, over the clip's own samples)
    -> STFT (n_fft 256, hop 128, periodic Hann)        (B, F=129, T, 2)
    -> Conv2d 2 -> D (3x3, padding 1), GroupNorm(1, D) (B, T, F, D=48)
    -> 6 x GridNetBlock (nn/blocks.py): sub-band BiLSTM over F, full-band
       BiLSTM over T (H 192, unfold of 4), multi-head attention over every
       frame (4 heads, E = ceil(512 / F) = 4)
    -> ConvTranspose2d D -> 2 (3x3, padding 1)        (B, F, T, 2)
       (the DC and Nyquist bins' imaginary parts zero)
    -> iSTFT, times the std

The STFT and the scaling belong to the entry point (``eval/infer.py``),
which reads them from the model: ``stft_config``, ``window`` and
``scale_by_std``.  The model is not ``causal``: every frame's output reads
every other frame, through the GroupNorm's statistics, the 3x3 convs, the
full-band BiLSTM's backward direction and its unfold windows, and the
attention.  So ``apply`` takes each row's own frame count, ``lengths`` (B,)
int64 on the device, and then computes each row exactly as that row alone
at its own length: the input frames past a row's length are zeroed, the
GroupNorm's statistics cover its valid frames, the full-band BiLSTM runs
over its own windows, the attention's keys are its valid frames, and its
output frames past its length are zero.  The lengths stay on the device, so
a captured CUDA graph serves every batch of a shape.

Departures from ESPnet, of layout and none of numbers: activations are
channels last, (B, T, F, C); the 1x1 convs run as one GEMM for every head's
Q, K and V; the transposed convs of the BiLSTMs as a GEMM and an
overlap-add of their taps.  Built at ESPnet's ``emb_hs`` 1, ``eps`` 1e-5,
PReLU activations and one source (``n_srcs`` 1: enhancement).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as tF
from torch import nn

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.dsp.stft import StftConfig
from gtcrn_micro_tpu_torch.models.gtcrn_micro import flatten, nest
from gtcrn_micro_tpu_torch.nn.blocks import GridNetBlock, MaskedGroupNorm
from gtcrn_micro_tpu_torch.nn.core import Ctx, exact_f32, name_paths


@dataclasses.dataclass(frozen=True)
class TFGridNetConfig:
    """ESPnet ``TFGridNet``'s arguments that size the model (its defaults but
    the STFT, which is 16 kHz's 16 ms window and 8 ms hop)."""

    n_fft: int = 256
    hop_len: int = 128
    n_layers: int = 6
    lstm_hidden_units: int = 192
    attn_n_head: int = 4
    attn_approx_qk_dim: int = 512
    emb_dim: int = 48
    emb_ks: int = 4

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


class SpectrumMapper(nn.Module):
    """The top level TF-GridNet and TF-Locoformer share, over their blocks:
    the input conv (Conv2d 2 -> C, 3x3, padding 1) with the gLN
    (:class:`MaskedGroupNorm`), ``blocks`` (each ``block(ctx, x, lengths,
    **extra)`` over (B, T, F, C)), the output transposed conv (C -> 2, 3x3,
    padding 1), the frames past each row's length zeroed on the way in,
    before the output conv and after it, and the DC and Nyquist bins'
    imaginary parts zeroed.  GTCRN's interface: ``apply``, ``load_params``,
    ``params``, ``device``, ``dtype``; the state dict is the published
    model's, leaf for leaf.  A subclass builds ``blocks`` and calls
    :meth:`_finish`."""

    window = "hann"
    causal = False

    def __init__(self, emb_dim: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(2, emb_dim, 3, padding=1), MaskedGroupNorm(emb_dim))

    def _finish(self, config, dtype, device) -> None:
        """The output conv; names, dtype, device and STFT (after ``blocks``)."""
        self.deconv = nn.ConvTranspose2d(config.emb_dim, 2, 3, padding=1)
        name_paths(self)
        dev = resolve_device(device)
        self.to(dev, dtype)
        self.config, self.dtype, self.device = config, dtype, dev
        self.stft_config = StftConfig(config.n_fft, config.hop_len, config.n_fft)

    @classmethod
    def from_params(cls, params: dict, dtype=torch.float32, device=None, config=None):
        model = cls(dtype=dtype, device=device) if config is None else cls(config, dtype, device)
        model.load_params(params)
        return model

    def load_params(self, params: dict) -> None:
        """Copy a param dict (nested, or flat with dotted keys: the published
        model's names) into the model, cast to its dtype; every leaf must be
        present with its shape, and no other."""
        flat = {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
                for k, v in flatten(params).items()}
        self.load_state_dict(flat, strict=True)

    def params(self) -> dict:
        """The nested param dict (tensors that share the model's storage)."""
        return nest(self.state_dict())

    def block_args(self, x) -> dict:
        """Keywords every block takes beside x (B, T, F, C) and the lengths."""
        return {}

    def forward(self, spec, ctx: Ctx, lengths=None):
        """spec (B, F, T, 2) -> the source's spec (B, F, T, 2); ``lengths``
        None (every frame valid) or (B,) int64: each row's own frames."""
        B, F, T, _ = spec.shape
        x = spec.transpose(1, 2)  # (B, T, F, 2)
        live = None
        if lengths is not None:
            live = (torch.arange(T, device=spec.device) < lengths[:, None])[:, :, None, None]
            x = torch.where(live, x, 0.0)
        x = x.contiguous().permute(0, 3, 1, 2)  # (B, 2, T, F), channels last
        x = self.conv[0](x).permute(0, 2, 3, 1).contiguous()  # (B, T, F, C)
        x = self.conv[1](x, lengths)
        extra = self.block_args(x)
        for block in self.blocks:
            x = block(ctx, x, lengths, **extra)
        if live is not None:
            x = torch.where(live, x, 0.0)
        y = tF.conv_transpose2d(x.permute(0, 3, 1, 2), self.deconv.weight, self.deconv.bias,
                                padding=1)  # (B, 2, T, F)
        y = y.permute(0, 3, 2, 1)  # (B, F, T, 2)
        if live is not None:
            y = torch.where(live.view(B, 1, T, 1), y, 0.0)
        y = y.contiguous()
        # the spectrum of a real signal: its DC and Nyquist bins are real (an
        # inverse real FFT on the CPU discards their imaginary parts; cuFFT's
        # leaves what it does with them to the plan)
        y[:, 0, :, 1] = 0.0
        y[:, -1, :, 1] = 0.0
        return y

    def apply(self, spec, lengths=None):
        """Offline forward of spec (B, F, T, 2) in the model's dtype on its
        device, float32 at full precision (TF32 off); ``lengths``: each
        row's own frame count (B,) int64 on the device, or None.  Autograd
        follows the caller's grad mode."""
        with exact_f32():
            return self(spec, Ctx(), lengths)


class TFGridNet(SpectrumMapper):
    """The layered TF-GridNet on one device, in one dtype.  Its state dict is
    ESPnet's ``TFGridNet`` separator's, leaf for leaf."""

    scale_by_std = True

    def __init__(self, config: TFGridNetConfig = TFGridNetConfig(), dtype=torch.float32,
                 device=None):
        """A model of ESPnet's initial weights (load others with
        :meth:`load_params`)."""
        c = config
        super().__init__(c.emb_dim)
        self.blocks = nn.ModuleList(
            GridNetBlock(c.emb_dim, c.emb_ks, c.n_freqs, c.lstm_hidden_units, c.attn_n_head,
                         c.attn_approx_qk_dim) for _ in range(c.n_layers))
        self._finish(c, dtype, device)
