"""Plain TF-GridNet: the parameter tree, a seeded initialisation on the
device, the forward in float32, and offline enhancement around it, written
from the published model (arXiv:2211.12433; ESPnet
``espnet2/enh/separator/tfgridnet_separator.py``: ``TFGridNet``,
``GridNetBlock``, ``LayerNormalization4D``, ``LayerNormalization4DCF``)
with plain ``torch`` operations only, in ESPnet's layout (B, C, T, F) and
with ESPnet's parameter names and shapes.

Every LSTM is written out as its cell (torch's gate order i, f, g, o): the
input projection of the whole sequence as one matmul, then the recurrence
step by step, not ``nn.LSTM``, which would run the program's own cuDNN
kernel:

    g = W_ih x_t + b_ih + W_hh h + b_hh
    c' = sigmoid(g_f) * c + sigmoid(g_i) * tanh(g_g)
    h' = sigmoid(g_o) * tanh(c')

The attention is a plain matmul and softmax, in blocks of query rows so
that a minute of audio fits.  Each clip is enhanced alone at its own
length, with no padding: divided by its own standard deviation (unbiased),
the STFT, the forward, the inverse STFT to its length, times the standard
deviation.  Clips of one length run as one batch, which changes nothing:
no operation mixes rows.  Float32 with TF32 off (``no_tf32``) is the
reference; TF32 on (``tf32``) is the correctness control.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

QUERY_ROWS = 1024  # query rows of one block of the attention
EPS = 1e-5  # every norm's


@dataclasses.dataclass(frozen=True)
class Config:
    """ESPnet ``TFGridNet``'s arguments that size the model; the defaults are
    its own but the STFT (16 kHz: a 16 ms window, an 8 ms hop).  Its other
    arguments are ESPnet's defaults, built in: ``emb_hs`` 1, ``eps`` 1e-5,
    PReLU, and one source (``n_srcs`` 1)."""

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

    @property
    def qk_dim(self) -> int:
        """E: the channels of a head's query and key."""
        return math.ceil(self.attn_approx_qk_dim / self.n_freqs)


def config_of(d: dict) -> Config:
    """The :class:`Config` of the keys of ``d`` that name its fields (a
    benchmark configuration's file)."""
    return Config(**{k: d[k] for k in Config.__dataclass_fields__ if k in d})


# ---------------------------------------------------------------------------
# the parameter tree: (path, shape, kind) of every leaf
# ---------------------------------------------------------------------------


def _conv(p, c_out, c_in, *k, transposed=False):
    """torch's default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias;
    a transposed conv's weight is (c_in, c_out, *k) and its fan_in c_out prod(k)."""
    shape = (c_in, c_out, *k) if transposed else (c_out, c_in, *k)
    b = 1 / math.sqrt(shape[1] * math.prod(k))
    return [(f"{p}.weight", shape, ("u", b)), (f"{p}.bias", (c_out,), ("u", b))]


def _norm(p, shape):
    return [(f"{p}.gamma", shape, ("gamma",)), (f"{p}.beta", shape, ("beta",))]


def _lstm(p, i, h):
    b = 1 / math.sqrt(h)
    out = []
    for sfx in ("", "_reverse"):
        out += [(f"{p}.weight_ih_l0{sfx}", (4 * h, i), ("u", b)),
                (f"{p}.weight_hh_l0{sfx}", (4 * h, h), ("u", b)),
                (f"{p}.bias_ih_l0{sfx}", (4 * h,), ("u", b)),
                (f"{p}.bias_hh_l0{sfx}", (4 * h,), ("u", b))]
    return out


def _attn_conv(p, c_out, c):
    return (_conv(f"{p}.0", c_out, c.emb_dim, 1, 1) + [(f"{p}.1.weight", (1,), ("alpha",))]
            + _norm(f"{p}.2", (1, c_out, 1, c.n_freqs)))


def leaf_specs(c: Config = Config()) -> list:
    """Every leaf of the tree, in ESPnet's order."""
    D, H, k = c.emb_dim, c.lstm_hidden_units, c.emb_ks
    specs = _conv("conv.0", D, 2, 3, 3) + [("conv.1.weight", (D,), ("gamma",)),
                                           ("conv.1.bias", (D,), ("beta",))]
    for b in range(c.n_layers):
        p = f"blocks.{b}"
        for side in ("intra", "inter"):
            specs += (_norm(f"{p}.{side}_norm", (1, D, 1, 1)) + _lstm(f"{p}.{side}_rnn", D * k, H)
                      + _conv(f"{p}.{side}_linear", D, 2 * H, k, transposed=True))
        for i in range(c.attn_n_head):
            specs += (_attn_conv(f"{p}.attn_conv_Q_{i}", c.qk_dim, c)
                      + _attn_conv(f"{p}.attn_conv_K_{i}", c.qk_dim, c)
                      + _attn_conv(f"{p}.attn_conv_V_{i}", D // c.attn_n_head, c))
        specs += _attn_conv(f"{p}.attn_concat_proj", D, c)
    return specs + _conv("deconv", 2, D, 3, 3, transposed=True)


def init_params(seed: int, device, c: Config = Config()) -> dict:
    """The flat parameter dict (ESPnet's dotted names -> float32 tensors on
    ``device``) from ``seed``: one draw of uniforms on the device mapped to
    torch's default ranges, norm affines near identity (gamma 0.8-1.2, beta
    within 0.1), PReLU slopes 0.15-0.35."""
    specs = leaf_specs(c)
    sizes = [math.prod(s) for _, s, _ in specs]
    scale, shift = np.empty(sum(sizes), np.float32), np.empty(sum(sizes), np.float32)
    ranges = {"gamma": (0.4, 0.8), "beta": (0.2, -0.1), "alpha": (0.2, 0.15)}
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


def lstm(P: dict, p: str, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The LSTM ``p`` (direction ``_reverse`` when ``reverse``) over x (N, S, I)
    from a zero state, one cell a step: (N, S, H)."""
    sfx = "_reverse" if reverse else ""
    w_hh = P[f"{p}.weight_hh_l0{sfx}"].T
    H = w_hh.shape[0]
    gi = x @ P[f"{p}.weight_ih_l0{sfx}"].T + (P[f"{p}.bias_ih_l0{sfx}"]
                                              + P[f"{p}.bias_hh_l0{sfx}"])  # (N, S, 4H)
    h = x.new_zeros((x.shape[0], H))
    c = torch.zeros_like(h)
    out = x.new_empty((x.shape[0], x.shape[1], H))
    for s in (reversed(range(x.shape[1])) if reverse else range(x.shape[1])):
        g = torch.addmm(gi[:, s], h, w_hh)
        sg = torch.sigmoid(g)
        c = sg[:, H:2 * H] * c + sg[:, :H] * torch.tanh(g[:, 2 * H:3 * H])
        h = sg[:, 3 * H:] * torch.tanh(c)
        out[:, s] = h
    return out


def bilstm(P: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    """Both directions of the BiLSTM ``p`` over x (N, S, I): :func:`lstm`'s
    cell, the two directions stepped together (the backward one over the
    sequence reversed), one batched matmul a step: (N, S, 2H)."""
    sfx = ("", "_reverse")
    w_hh = torch.stack([P[f"{p}.weight_hh_l0{d}"].T for d in sfx])  # (2, H, 4H)
    H = w_hh.shape[1]
    gi = x.new_empty((2, *x.shape[:2], 4 * H))  # the input projections, backward's reversed
    for k, (d, xd) in enumerate(zip(sfx, (x, x.flip(1)))):
        torch.matmul(xd, P[f"{p}.weight_ih_l0{d}"].T, out=gi[k])
        gi[k] += P[f"{p}.bias_ih_l0{d}"] + P[f"{p}.bias_hh_l0{d}"]
    h = x.new_zeros((2, x.shape[0], H))
    c = torch.zeros_like(h)
    out = x.new_empty((2, x.shape[0], x.shape[1], H))
    for s in range(x.shape[1]):
        g = torch.baddbmm(gi[:, :, s], h, w_hh)
        sg = torch.sigmoid(g)
        c = sg[..., H:2 * H] * c + sg[..., :H] * torch.tanh(g[..., 2 * H:3 * H])
        h = sg[..., 3 * H:] * torch.tanh(c)
        out[:, :, s] = h
    return torch.cat([out[0], out[1].flip(1)], dim=-1)


def layer_norm(P: dict, p: str, x: torch.Tensor, dims: tuple, eps: float) -> torch.Tensor:
    """(x - mean) / sqrt(biased var + eps) over ``dims``, times gamma, plus beta."""
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * P[f"{p}.gamma"] + P[f"{p}.beta"]


def attn_conv(P: dict, p: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    """1x1 conv, PReLU, LayerNormalization4DCF over (C, F)."""
    y = F.conv2d(x, P[f"{p}.0.weight"], P[f"{p}.0.bias"])
    y = torch.where(y >= 0, y, y * P[f"{p}.1.weight"])
    return layer_norm(P, f"{p}.2", y, (1, 3), eps)


def _dual_path(P: dict, p: str, side: str, x: torch.Tensor, c: Config) -> torch.Tensor:
    """One of the block's two RNN paths over x (N, C, S): norm already taken;
    unfold, BiLSTM, transposed conv -> (N, C, S)."""
    u = F.unfold(x[..., None], (c.emb_ks, 1))  # (N, C k, S - k + 1)
    h = bilstm(P, f"{p}.{side}_rnn", u.transpose(1, 2))
    return F.conv_transpose1d(h.transpose(1, 2), P[f"{p}.{side}_linear.weight"],
                              P[f"{p}.{side}_linear.bias"])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (N, T, d), in blocks of query rows."""
    scale = 1 / q.shape[-1] ** 0.5
    kt = k.transpose(1, 2)
    out = v.new_empty((*q.shape[:2], v.shape[-1]))
    for r in range(0, q.shape[1], QUERY_ROWS):
        a = torch.softmax(torch.matmul(q[:, r:r + QUERY_ROWS], kt) * scale, dim=-1)
        out[:, r:r + QUERY_ROWS] = torch.matmul(a, v)
    return out


def block(P: dict, p: str, x: torch.Tensor, c: Config) -> torch.Tensor:
    """ESPnet's ``GridNetBlock.forward`` over x (B, C, T, F)."""
    B, C, T, Q = x.shape
    eps = EPS
    # intra (sub-band): over F inside each frame
    h = layer_norm(P, f"{p}.intra_norm", x, (1,), eps).transpose(1, 2).reshape(B * T, C, Q)
    x = _dual_path(P, p, "intra", h, c).view(B, T, C, Q).transpose(1, 2) + x
    # inter (full-band): over T at each frequency
    h = layer_norm(P, f"{p}.inter_norm", x, (1,), eps).permute(0, 3, 1, 2).reshape(B * Q, C, T)
    x = _dual_path(P, p, "inter", h, c).view(B, Q, C, T).permute(0, 2, 3, 1) + x
    # full-band self-attention over every frame
    L = c.attn_n_head
    qs, ks, vs = ([attn_conv(P, f"{p}.attn_conv_{kind}_{i}", x, eps) for i in range(L)]
                  for kind in "QKV")
    q, k, v = (torch.cat(t, dim=0).transpose(1, 2) for t in (qs, ks, vs))  # (L B, T, c, F)
    shape = v.shape
    o = attention(q.flatten(2), k.flatten(2), v.flatten(2)).reshape(shape).transpose(1, 2)
    o = o.reshape(L, B, shape[2], T, Q).transpose(0, 1).reshape(B, L * shape[2], T, Q)
    return attn_conv(P, f"{p}.attn_concat_proj", o, eps) + x


def forward(P: dict, spec: torch.Tensor, c: Config = Config()) -> torch.Tensor:
    """spec (B, F, T, 2) float32 -> the source's spec (B, F, T, 2), its DC
    and Nyquist bins real."""
    x = spec.permute(0, 3, 2, 1)  # (B, 2, T, F)
    x = F.conv2d(x, P["conv.0.weight"], P["conv.0.bias"], padding=1)
    x = F.group_norm(x, 1, P["conv.1.weight"], P["conv.1.bias"], EPS)
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
    std = x.std(dim=1, keepdim=True)
    s = torch.stft(x / std, c.n_fft, c.hop_len, c.n_fft, win, center=True, pad_mode="reflect",
                   normalized=False, onesided=True, return_complex=True)
    with torch.no_grad():
        y = forward(P, torch.view_as_real(s), c)
    out = torch.istft(torch.view_as_complex(y.contiguous()), c.n_fft, c.hop_len, c.n_fft, win,
                      center=True, normalized=False, onesided=True, length=x.shape[1])
    return out * std


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
