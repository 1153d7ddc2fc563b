"""TF-Locoformer on the port's offline path: the layered model.

TF-Locoformer (K. Saijo, G. Wichern, F. G. Germain, Z. Pan, J. Le Roux,
"TF-Locoformer: Transformer with Local Modeling by Convolution for Speech
Separation and Enhancement", IWAENC 2024, arXiv:2408.03440; MERL's
``tf-locoformer``, class ``TFLocoformerSeparator``) maps the complex
spectrum of a mixture to the complex spectrum of each source with
transformer blocks along frequency and along time.  Top-level graph, at
the class's defaults (the medium model) with one source:

    STFT (n_fft 256, hop 128, periodic Hann)          (B, F=129, T, 2)
    -> Conv2d 2 -> C (3x3, padding 1), GroupNorm(1, C) (B, T, F, C=128)
    -> 6 x TFLocoformerBlock (nn/blocks.py): a LocoformerBlock over the F
       bins of every frame, then one over the T frames of every bin; each
       macaron: conv-SwiGLU FFN (kernel 4, 384 hidden), RoPE self-attention
       (4 heads of 32), conv-SwiGLU FFN, each behind an RMSGroupNorm (4
       groups), each residual
    -> ConvTranspose2d C -> 2 (3x3, padding 1)         (B, F, T, 2)
       (the DC and Nyquist bins' imaginary parts zero)
    -> iSTFT

The top level is TF-GridNet's (``models/tfgridnet.SpectrumMapper``), and
the entry point runs it as it runs TF-GridNet, without scaling the
waveform.  The model is not ``causal``: along time every frame's output
reads every other frame, through the gLN's statistics, the 3x3 convs, the
FFNs' convs (three frames each side) and the attention.  So ``apply`` takes
each row's own frame count, ``lengths`` (B,) int64 on the device, and
computes each row exactly as that row alone at its own length: the input
frames past a row's length are zeroed, the gLN's statistics cover its valid
frames, the residual stream along time is zero past them at the input of
every time-path sub-layer (an RMSGroupNorm maps zero to zero, so the FFN's
zero padding is the row's own), the attention's keys are its valid frames,
rotary positions start at 0 in every row, and its output frames past its
length are zero.

Departures from MERL's code, of layout and none of numbers: activations
are channels last, (B, T, F, C); a conv1d runs as one GEMM over its
windows, a transposed conv1d as a GEMM and an overlap-add of its taps (on
a card at grad off each FFN sub-layer, norm and residual included, is one
kernel instead, ``ops/loco_ffn``: three TF32 products a float32 product); the
rotary tables (rotary-embedding-torch ``RotaryEmbedding(32)``: theta
10,000, interleaved pairs) are computed, not kept in the state dict
(MERL's ``attn.rope.freqs`` leaves, fixed, are left out), their angles in
float64.  Built at ``tf_order`` "ft", ``conv1d_shift`` 1 (the block's
padding is then none), dropout 0, eps 1e-5 and one source (``num_spk`` 1).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from gtcrn_micro_tpu_torch.models.tfgridnet import SpectrumMapper
from gtcrn_micro_tpu_torch.nn.blocks import TFLocoformerBlock
from gtcrn_micro_tpu_torch.nn.core import rope_table


@dataclasses.dataclass(frozen=True)
class TFLocoformerConfig:
    """MERL ``TFLocoformerSeparator``'s arguments that size the model (its
    defaults, the medium model, but the STFT, which is 16 kHz's 16 ms window
    and 8 ms hop as TF-GridNet's)."""

    n_fft: int = 256
    hop_len: int = 128
    n_layers: int = 6
    emb_dim: int = 128
    num_groups: int = 4
    n_heads: int = 4
    attention_dim: int = 128
    ffn_hidden_dim: int = 384
    conv1d_kernel: int = 4

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


class TFLocoformer(SpectrumMapper):
    """The layered TF-Locoformer on one device, in one dtype.  Its state dict
    is MERL's ``TFLocoformerSeparator``'s, leaf for leaf, less the rotary
    embeddings' fixed ``freqs``."""

    scale_by_std = False

    def __init__(self, config: TFLocoformerConfig = TFLocoformerConfig(), dtype=torch.float32,
                 device=None):
        """A model of torch's initial weights (load others with
        :meth:`load_params`)."""
        c = config
        super().__init__(c.emb_dim)
        self.blocks = nn.ModuleList(
            TFLocoformerBlock(c.emb_dim, c.ffn_hidden_dim, c.conv1d_kernel, c.n_heads,
                              c.attention_dim, c.num_groups) for _ in range(c.n_layers))
        self._finish(c, dtype, device)

    def block_args(self, x) -> dict:
        """The rotary tables of the F bins and of the T frames, shared by
        every block."""
        c = self.config
        head = c.attention_dim // c.n_heads
        return {"tables": (rope_table(x.shape[2], head, x.device),
                           rope_table(x.shape[1], head, x.device))}
