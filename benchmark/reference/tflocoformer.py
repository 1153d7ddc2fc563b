"""Plain TF-Locoformer: the parameter tree, a seeded initialisation on the
device, the forward in float32, and offline enhancement around it, written
from the published model (arXiv:2408.03440; MERL ``tf-locoformer``:
``TFLocoformerSeparator``, ``TFLocoformerBlock``, ``LocoformerBlock``,
``MultiHeadSelfAttention``, ``SwiGLUConvDeconv1d``, ``RMSGroupNorm``) with
plain ``torch`` operations only, in MERL's layout (B, C, T, F) and with
MERL's parameter names and shapes.

A ``LocoformerBlock`` over sequences x (N, S, C), in macaron order:

    x = x + FFN_1(RMSGN_ffn_1(x))
    x = x + MHSA(RMSGN_attn(x))
    x = x + FFN_0(RMSGN_ffn_0(x))

RMSGN: each group of C / G channels over (its L2 norm / sqrt(C / G) +
eps), times gamma.  FFN: zero pad of k - 1 each side, Conv1d C -> 2 H
(kernel k), u * SiLU(g) of its halves, ConvTranspose1d H -> C (kernel k),
positions [k - 1, k - 1 + S).  MHSA: qkv = x W_qkv read as (S, 3, heads,
d); the queries and keys rotated (RoPE, rotary-embedding-torch's
``RotaryEmbedding(d)``: pair i = (2i, 2i + 1) at position p turned by p
10000^(-2i / d), positions from 0); softmax(q k^T / sqrt(d)) v in each
head; the heads concatenated, times W_o.  A ``TFLocoformerBlock`` runs one
over the F bins of every frame, then another over the T frames of every
bin.

The attention is a plain matmul and softmax in blocks of sequences and of
query rows, each score block at most ``SCORE_BYTES`` (2 GiB: 16 sequences
of 4 heads x 1,024 rows x 7,501 keys along time at a minute of audio);
a LocoformerBlock runs over its sequences in chunks of at most
``POSITIONS`` positions (its FFN's conv output then 3.2 GB).  Neither
changes a number: no operation mixes sequences.  Each clip is enhanced
alone at its own length, with no padding and no scaling: the STFT, the
forward, the inverse STFT to its length.  Clips of one length run as one
batch, which changes nothing.  Float32 with TF32 off (``no_tf32``) is the
reference; TF32 on (``tf32``) is the correctness control.

Departures from the published model: one source (``num_spk`` 1); the 16
kHz STFT of TF-GridNet's configuration (n_fft 256, hop 128, periodic
Hann); the rotary angles taken in float64 and their cosines and sines
rounded to float32 (rotary-embedding-torch takes them in float32, which at
position 7,500 moves an angle by up to ~5e-4 rad); the rotary ``freqs``
leaves, fixed, not in the tree; seeded weights, no checkpoint.  Built at
the class's defaults otherwise: ``tf_order`` "ft", ``conv1d_shift`` 1,
dropout 0, eps 1e-5, RMSGroupNorm without bias.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5  # every norm's
THETA = 10000.0  # the rotary embedding's base
QUERY_ROWS = 1024  # query rows of one block of the attention
SCORE_BYTES = 1 << 31  # the most one block of attention scores takes
POSITIONS = 1 << 20  # sequence positions one LocoformerBlock runs at once


@dataclasses.dataclass(frozen=True)
class Config:
    """MERL ``TFLocoformerSeparator``'s arguments that size the model; the
    defaults are its own (the medium model) but the STFT (16 kHz: a 16 ms
    window, an 8 ms hop)."""

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


def config_of(d: dict) -> Config:
    """The :class:`Config` of the keys of ``d`` that name its fields (a
    benchmark configuration's file)."""
    return Config(**{k: d[k] for k in Config.__dataclass_fields__ if k in d})


# ---------------------------------------------------------------------------
# the parameter tree: (path, shape, kind) of every leaf
# ---------------------------------------------------------------------------


def _uniform(p: str, shape: tuple, fan_in: int, bias: bool = True,
             transposed: bool = False) -> list:
    """torch's default for a conv or linear layer: U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for weight and bias; a transposed conv's weight is
    (c_in, c_out, *k)."""
    b = 1 / math.sqrt(fan_in)
    out = [(f"{p}.weight", shape, ("u", b))]
    return out + [(f"{p}.bias", (shape[1] if transposed else shape[0],), ("u", b))] * bias


def _path(p: str, c: Config) -> list:
    C, H, k, A = c.emb_dim, c.ffn_hidden_dim, c.conv1d_kernel, c.attention_dim
    specs = [(f"{p}.ffn_norm.{i}.gamma", (C,), ("gamma",)) for i in range(2)]
    for i in range(2):
        specs += (_uniform(f"{p}.ffn.{i}.conv1d", (2 * H, C, k), C * k)
                  + _uniform(f"{p}.ffn.{i}.deconv1d", (H, C, k), C * k, transposed=True))
    return specs + ([(f"{p}.attn_norm.gamma", (C,), ("gamma",))]
                    + _uniform(f"{p}.attn.qkv", (3 * A, C), C, bias=False)
                    + _uniform(f"{p}.attn.aggregate_heads.0", (C, A), A, bias=False))


def leaf_specs(c: Config = Config()) -> list:
    """Every leaf of the tree, in MERL's order (less the rotary ``freqs``)."""
    C = c.emb_dim
    specs = _uniform("conv.0", (C, 2, 3, 3), 2 * 9) + [("conv.1.weight", (C,), ("gamma",)),
                                                      ("conv.1.bias", (C,), ("beta",))]
    for b in range(c.n_layers):
        specs += _path(f"blocks.{b}.freq_path", c) + _path(f"blocks.{b}.frame_path", c)
    return specs + _uniform("deconv", (C, 2, 3, 3), 2 * 9, transposed=True)


def init_params(seed: int, device, c: Config = Config()) -> dict:
    """The flat parameter dict (MERL's dotted names -> float32 tensors on
    ``device``) from ``seed``: one draw of uniforms on the device mapped to
    torch's default ranges, norm weights near 1 (0.8-1.2), the gLN's bias
    within 0.1."""
    specs = leaf_specs(c)
    sizes = [math.prod(s) for _, s, _ in specs]
    scale, shift = np.empty(sum(sizes), np.float32), np.empty(sum(sizes), np.float32)
    ranges = {"gamma": (0.4, 0.8), "beta": (0.2, -0.1)}
    o = 0
    for (_, _, kind), n in zip(specs, sizes):
        a, b = (2 * kind[1], -kind[1]) if kind[0] == "u" else ranges[kind[0]]
        scale[o:o + n], shift[o:o + n] = a, b
        o += n
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(o, generator=gen, device=device, dtype=torch.float32)
    flat = u * torch.from_numpy(scale).to(device) + torch.from_numpy(shift).to(device)
    return {p: t.view(s) for (p, s, _), t in zip(specs, flat.split(sizes))}


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def rms_group_norm(P: dict, p: str, x: torch.Tensor, groups: int) -> torch.Tensor:
    """MERL's ``RMSGroupNorm`` over the last axis of x."""
    g = x.reshape(*x.shape[:-1], groups, -1)
    rms = g.norm(2, dim=-1, keepdim=True) * g.shape[-1] ** -0.5
    return (g / (rms + EPS)).reshape(x.shape) * P[f"{p}.gamma"]


def ffn(P: dict, p: str, x: torch.Tensor, c: Config) -> torch.Tensor:
    """MERL's ``SwiGLUConvDeconv1d`` at stride 1 over x (N, S, C)."""
    S, k, H = x.shape[1], c.conv1d_kernel, c.ffn_hidden_dim
    h = F.pad(x.transpose(1, 2), (k - 1, k - 1))  # (N, C, S + 2 (k - 1))
    h = F.conv1d(h, P[f"{p}.conv1d.weight"], P[f"{p}.conv1d.bias"])
    h = h[:, :H] * F.silu(h[:, H:])
    h = F.conv_transpose1d(h, P[f"{p}.deconv1d.weight"], P[f"{p}.deconv1d.bias"])
    return h[..., k - 1:k - 1 + S].transpose(1, 2)


def rotate(x: torch.Tensor) -> torch.Tensor:
    """x (N, heads, S, d) with its interleaved pairs rotated by position:
    x'[2i] = x[2i] cos - x[2i + 1] sin, x'[2i + 1] = x[2i + 1] cos + x[2i]
    sin, at angle p THETA^(-2i / d)."""
    S, d = x.shape[-2:]
    inv = THETA ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    angle = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv  # (S, d / 2)
    cos, sin = angle.cos().float(), angle.sin().float()
    even, odd = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = even * cos - odd * sin
    out[..., 1::2] = odd * cos + even * sin
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (N, heads, S, d), in blocks of
    sequences and of query rows."""
    N, L, S, d = q.shape
    rows = min(QUERY_ROWS, S)
    seqs = max(1, SCORE_BYTES // (L * rows * S * 4))
    out = torch.empty_like(v)
    for n in range(0, N, seqs):
        kt = k[n:n + seqs].transpose(-1, -2)
        for r in range(0, S, rows):
            a = torch.softmax(torch.matmul(q[n:n + seqs, :, r:r + rows], kt) / math.sqrt(d),
                              dim=-1)
            out[n:n + seqs, :, r:r + rows] = torch.matmul(a, v[n:n + seqs])
    return out


def mhsa(P: dict, p: str, x: torch.Tensor, c: Config) -> torch.Tensor:
    """MERL's ``MultiHeadSelfAttention`` over x (N, S, C)."""
    N, S, _ = x.shape
    qkv = (x @ P[f"{p}.qkv.weight"].T).reshape(N, S, 3, c.n_heads, -1).movedim(-2, 1)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]  # (N, heads, S, d)
    o = attention(rotate(q), rotate(k), v).transpose(1, 2).reshape(N, S, -1)
    return o @ P[f"{p}.aggregate_heads.0.weight"].T


def locoformer(P: dict, p: str, x: torch.Tensor, c: Config) -> torch.Tensor:
    """MERL's ``LocoformerBlock`` (macaron) over x (N, S, C), in chunks of
    sequences."""
    out = torch.empty_like(x)
    G, seqs = c.num_groups, max(1, POSITIONS // x.shape[1])
    for n in range(0, x.shape[0], seqs):
        h = x[n:n + seqs]
        h = h + ffn(P, f"{p}.ffn.1", rms_group_norm(P, f"{p}.ffn_norm.1", h, G), c)
        h = h + mhsa(P, f"{p}.attn", rms_group_norm(P, f"{p}.attn_norm", h, G), c)
        h = h + ffn(P, f"{p}.ffn.0", rms_group_norm(P, f"{p}.ffn_norm.0", h, G), c)
        out[n:n + seqs] = h
    return out


def block(P: dict, p: str, x: torch.Tensor, c: Config) -> torch.Tensor:
    """MERL's ``TFLocoformerBlock.forward`` (``tf_order`` "ft") over x (B, C,
    T, F)."""
    B, C, T, Q = x.shape
    h = x.movedim(1, -1)  # (B, T, F, C)
    h = locoformer(P, f"{p}.freq_path", h.reshape(B * T, Q, C), c).view(B, T, Q, C)
    h = locoformer(P, f"{p}.frame_path", h.transpose(1, 2).reshape(B * Q, T, C), c)
    return h.view(B, Q, T, C).transpose(1, 2).movedim(-1, 1)


def group_norm(P: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    """``GroupNorm(1, C)`` over x (B, C, T, F): each row less its mean over
    (C, T, F), over the root of its biased variance plus eps, times weight,
    plus bias, per channel.  Not ``F.group_norm``, whose CUDA kernel sums a
    row's 124 M values of a minute of audio in one block's threads and
    moves the result by ~3e-5 relative."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    w, b = P[f"{p}.weight"][:, None, None], P[f"{p}.bias"][:, None, None]
    return (x - mean) / torch.sqrt(var + EPS) * w + b


def forward(P: dict, spec: torch.Tensor, c: Config = Config()) -> torch.Tensor:
    """spec (B, F, T, 2) float32 -> the source's spec (B, F, T, 2), its DC
    and Nyquist bins real."""
    x = spec.permute(0, 3, 2, 1)  # (B, 2, T, F)
    x = F.conv2d(x, P["conv.0.weight"], P["conv.0.bias"], padding=1)
    x = group_norm(P, "conv.1", x)
    for b in range(c.n_layers):
        x = block(P, f"blocks.{b}", x, c)
    y = F.conv_transpose2d(x, P["deconv.weight"], P["deconv.bias"], padding=1)  # (B, 2, T, F)
    y = y.permute(0, 3, 2, 1).contiguous()
    # a real signal's DC and Nyquist bins are real: torch.istft on the CPU
    # discards their imaginary parts, cuFFT's inverse leaves them to the plan
    y[:, 0, :, 1] = 0.0
    y[:, -1, :, 1] = 0.0
    return y


# ---------------------------------------------------------------------------
# enhancement around the forward
# ---------------------------------------------------------------------------


def enhance(P: dict, x: torch.Tensor, c: Config = Config()) -> torch.Tensor:
    """Clips of one length, (B, n) float32, each enhanced alone: (B, n)."""
    win = torch.hann_window(c.n_fft, periodic=True, dtype=torch.float64).float().to(x.device)
    s = torch.stft(x, c.n_fft, c.hop_len, c.n_fft, win, center=True, pad_mode="reflect",
                   normalized=False, onesided=True, return_complex=True)
    with torch.no_grad():
        y = forward(P, torch.view_as_real(s), c)
    return torch.istft(torch.view_as_complex(y.contiguous()), c.n_fft, c.hop_len, c.n_fft, win,
                       center=True, normalized=False, onesided=True, length=x.shape[1])


def offline_enhance(P: dict, clips: list, device, c: Config = Config()) -> list:
    """Enhanced float32 waveforms of ``clips`` (float32 numpy arrays), each
    alone at its own length (clips of one length as one batch)."""
    out: list = [None] * len(clips)
    for n in sorted({len(x) for x in clips}):
        idx = [i for i, x in enumerate(clips) if len(x) == n]
        batch = torch.from_numpy(np.stack([clips[i] for i in idx])).to(device)
        wav = enhance(P, batch, c).cpu().numpy()
        for k, i in enumerate(idx):
            out[i] = wav[k]
    return out


def no_tf32():
    """Float32 products and convolutions at full float32 precision (TF32 off
    in cuBLAS and cuDNN) inside the block."""
    return _Flags(False)


def tf32():
    """TF32 on in cuBLAS and cuDNN inside the block (the control's precision
    for a float32 configuration)."""
    return _Flags(True)


class _Flags:
    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        self.saved = mm.allow_tf32, cudnn.allow_tf32
        mm.allow_tf32 = cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
