"""Plain GTCRN: the parameter tree, a seeded initialisation on the device,
the offline forward in float32, and the offline and streamed enhancement
around it, written from the published model (Xiaobin-Rong/gtcrn,
``gtcrn.py``: ``GTCRN``, ``DPGRNN``, ``GRNN``, ``TRA``, ``SFE``,
``GTConvBlock``) with plain ``torch`` operations only.

Every GRU is written out as its cell (torch's gate order r, z, n) in a loop
over its sequence, not ``nn.GRU``, which would run the program's own cuDNN
kernel:

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

The convolutions, BatchNorms, PReLUs and ERB filters are GTCRN-Micro's
reference's (``benchmark/reference/gtcrn.py``), whose layouts the parameter
tree keeps: convs HWIO ``(kT, kF, C_in/groups, C_out)``, transposed convs
(the decoder's) as flipped-kernel causal convs, pointwise and linear
weights ``(C_in, C_out)``; GRUs keep torch's leaf names and layouts.
Layout inside is upstream's ``(B, C, T, F)``.  Every temporal op is causal,
so the forward over T frames equals T streamed steps from zero state.
Float32 with TF32 off (``no_tf32``) is the reference; TF32 on (``tf32``)
is the correctness control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import dsp, gtcrn
# nest, is_trainable, no_tf32 and tf32 serve this tree as they serve GTCRN-Micro's
from benchmark.reference.gtcrn import (  # noqa: F401
    _act,
    _bn,
    _conv,
    _pw,
    erb_filters,
    is_trainable,
    nest,
    no_tf32,
    tf32,
)

C, HALF, WIDTH, HIDDEN = 16, 8, 33, 16
DILATIONS = (1, 2, 5)


# ---------------------------------------------------------------------------
# the parameter tree: (path, shape, kind) of every leaf
# ---------------------------------------------------------------------------


def _gru(p, i, h, bidirectional=False):
    b = 1.0 / math.sqrt(h)
    out = []
    for sfx in ("", "_reverse") if bidirectional else ("",):
        out += [(f"{p}.weight_ih_l0{sfx}", (3 * h, i), ("u", b)),
                (f"{p}.weight_hh_l0{sfx}", (3 * h, h), ("u", b)),
                (f"{p}.bias_ih_l0{sfx}", (3 * h,), ("u", b)),
                (f"{p}.bias_hh_l0{sfx}", (3 * h,), ("u", b))]
    return out


def _ln(p):
    return [(f"{p}.gamma", (WIDTH, HIDDEN), ("gamma",)),
            (f"{p}.beta", (WIDTH, HIDDEN), ("beta",))]


def _conv_block(p, cin_g, cout, last=False):
    return _conv(f"{p}.conv", 1, 5, cin_g, cout) + _bn(f"{p}.bn", cout) + (
        [] if last else _act(f"{p}.act"))


def _gtconv(p):
    return (_pw(f"{p}.point_conv1", 3 * HALF, C) + _bn(f"{p}.point_bn1", C)
            + _act(f"{p}.point_act")
            + _conv(f"{p}.depth_conv", 3, 3, 1, C) + _bn(f"{p}.depth_bn", C)
            + _act(f"{p}.depth_act")
            + _pw(f"{p}.point_conv2", C, HALF) + _bn(f"{p}.point_bn2", HALF)
            + _gru(f"{p}.tra.att_gru", HALF, 2 * HALF) + _pw(f"{p}.tra.att_fc", 2 * HALF, HALF))


def _dpgrnn(p):
    out = []
    for g in (1, 2):
        out += _gru(f"{p}.intra_rnn.rnn{g}", HALF, HIDDEN // 4, bidirectional=True)
    out += _pw(f"{p}.intra_fc", HIDDEN, HIDDEN) + _ln(f"{p}.intra_ln")
    for g in (1, 2):
        out += _gru(f"{p}.inter_rnn.rnn{g}", HALF, HIDDEN // 2)
    return out + _pw(f"{p}.inter_fc", HIDDEN, HIDDEN) + _ln(f"{p}.inter_ln")


def leaf_specs() -> list:
    """Every leaf of the tree except the ERB filters, in a fixed order."""
    specs = _conv_block("encoder.en0", 9, C) + _conv_block("encoder.en1", C // 2, C)
    for i in (2, 3, 4):
        specs += _gtconv(f"encoder.en{i}")
    specs += _dpgrnn("dpgrnn1") + _dpgrnn("dpgrnn2")
    for i in (0, 1, 2):
        specs += _gtconv(f"decoder.de{i}")
    return specs + _conv_block("decoder.de3", C // 2, C) + _conv_block("decoder.de4", C, 2,
                                                                       last=True)


def init_params(seed: int, device) -> dict:
    """The flat parameter dict (dotted paths -> float32 tensors on
    ``device``) from ``seed``, drawn as GTCRN-Micro's reference draws its
    own: one draw of uniforms on the device mapped to torch's default ranges
    (GRUs U(-1/sqrt(H), 1/sqrt(H))), BatchNorm and LayerNorm affines near
    identity (gamma 0.8-1.2, beta within 0.1), PReLU slopes 0.15-0.35; then
    every BatchNorm's running statistics set to the batch statistics of one
    training-mode forward over 8 speech-like clips of 2 s drawn from the
    same generator."""
    specs = leaf_specs()
    sizes = [math.prod(s) for _, s, _ in specs]
    scale, shift = np.empty(sum(sizes), np.float32), np.empty(sum(sizes), np.float32)
    ranges = {"gamma": (0.4, 0.8), "beta": (0.2, -0.1), "mean": (0.0, 0.0),
              "var": (0.0, 1.0), "alpha": (0.2, 0.15)}
    o = 0
    for (_, _, kind), n in zip(specs, sizes):
        a, b = (2 * kind[1], -kind[1]) if kind[0] == "u" else ranges[kind[0]]
        scale[o:o + n], shift[o:o + n] = a, b
        o += n
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(o, generator=gen, device=device, dtype=torch.float32)
    flat = u * torch.from_numpy(scale).to(device) + torch.from_numpy(shift).to(device)
    out = {p: t.view(s) for (p, s, _), t in zip(specs, flat.split(sizes))}
    f = erb_filters()
    out["erb.bm_w"] = torch.from_numpy(np.ascontiguousarray(f.T)).to(device)
    out["erb.bs_w"] = torch.from_numpy(np.ascontiguousarray(f)).to(device)
    from benchmark.inputs import speech_like

    clips = speech_like(8, 32000, gen, device)
    with torch.no_grad(), no_tf32():
        _, stats = forward(out, dsp.stft(clips, dsp.sqrt_hann(device)), training=True)
    for p, (mean, var) in stats.items():
        out[f"{p}.running_mean"], out[f"{p}.running_var"] = mean, var
    return out


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def gru(P: dict, p: str, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The GRU ``p`` (direction ``_reverse`` when ``reverse``) over x (N, S, I)
    from a zero state, one cell a step: (N, S, H)."""
    sfx = "_reverse" if reverse else ""
    w_hh, b_hh = P[f"{p}.weight_hh_l0{sfx}"], P[f"{p}.bias_hh_l0{sfx}"]
    H = w_hh.shape[1]
    gi = x @ P[f"{p}.weight_ih_l0{sfx}"].T + P[f"{p}.bias_ih_l0{sfx}"]  # (N, S, 3H)
    h = x.new_zeros((x.shape[0], H))
    ys = [None] * x.shape[1]
    for s in (reversed(range(x.shape[1])) if reverse else range(x.shape[1])):
        gh = h @ w_hh.T + b_hh
        r = torch.sigmoid(gi[:, s, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, s, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, s, 2 * H:] + r * gh[:, 2 * H:])
        h = (1 - z) * n + z * h
        ys[s] = h
    return torch.stack(ys, dim=1)


def layer_norm(P: dict, p: str, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """LayerNorm over the last two axes (F, C) jointly, biased variance."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(-2, -1), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * P[f"{p}.gamma"] + P[f"{p}.beta"]


def linear(P: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    return x @ P[f"{p}.w"] + P[f"{p}.b"]


class _Run(gtcrn._Run):
    """One forward of GTCRN: GTCRN-Micro's reference's convs, BatchNorms,
    PReLUs and ERB filters, with GTCRN's blocks."""

    def conv_block(self, p, x, up=False, last=False, groups=1):
        y = self.bn(f"{p}.bn", self.conv(f"{p}.conv", x, pad_f=2, stride_f=1 if up else 2,
                                         up=2 if up else 1, groups=groups))
        return torch.tanh(y) if last else self.prelu(f"{p}.act", y)

    @staticmethod
    def sfe(x):
        """Unfold (1, 3) over frequency, one zero of padding each side:
        (B, C, T, F) -> (B, 3C, T, F), channel 3c + k = x[c, f + k - 1]."""
        B, Cc, T, Fq = x.shape
        return F.unfold(x, kernel_size=(1, 3), padding=(0, 1)).reshape(B, 3 * Cc, T, Fq)

    def tra(self, p, x):
        zt = (x * x).mean(dim=3)  # (B, C, T)
        at = gru(self.P, f"{p}.att_gru", zt.transpose(1, 2))  # (B, T, 2C)
        g = torch.sigmoid(linear(self.P, f"{p}.att_fc", at)).transpose(1, 2)  # (B, C, T)
        return x * g[..., None]

    def gtconv(self, p, x, d):
        x1, x2 = x[:, :HALF], x[:, HALF:]
        h = self.prelu(f"{p}.point_act",
                       self.bn(f"{p}.point_bn1", self.pw(f"{p}.point_conv1", self.sfe(x1))))
        h = self.conv(f"{p}.depth_conv", h, dil_t=d, pad_f=1, groups=C)
        h = self.prelu(f"{p}.depth_act", self.bn(f"{p}.depth_bn", h))
        h = self.bn(f"{p}.point_bn2", self.pw(f"{p}.point_conv2", h))
        h = self.tra(f"{p}.tra", h)
        return torch.stack([h, x2], dim=2).flatten(1, 2)  # out[2c] = h[c], out[2c+1] = x2[c]

    def dpgrnn(self, p, x):
        P = self.P
        x = x.permute(0, 2, 3, 1)  # (B, T, F, C)
        B, T, Fq, Cc = x.shape
        intra = x.reshape(B * T, Fq, Cc)
        ys = []
        for g in (1, 2):
            xg = intra[..., (g - 1) * HALF:g * HALF]
            q = f"{p}.intra_rnn.rnn{g}"
            ys += [gru(P, q, xg), gru(P, q, xg, reverse=True)]
        y = linear(P, f"{p}.intra_fc", torch.cat(ys, dim=-1)).reshape(B, T, Fq, HIDDEN)
        x = x + layer_norm(P, f"{p}.intra_ln", y)
        inter = x.permute(0, 2, 1, 3).reshape(B * Fq, T, Cc)
        ys = [gru(P, f"{p}.inter_rnn.rnn{g}", inter[..., (g - 1) * HALF:g * HALF])
              for g in (1, 2)]
        y = linear(P, f"{p}.inter_fc", torch.cat(ys, dim=-1)).reshape(B, Fq, T, HIDDEN)
        x = x + layer_norm(P, f"{p}.inter_ln", y.permute(0, 2, 1, 3))
        return x.permute(0, 3, 1, 2)  # (B, C, T, F)

    def __call__(self, spec):
        re, im = spec[..., 0].transpose(1, 2), spec[..., 1].transpose(1, 2)  # (B, T, F)
        mag = torch.sqrt(re * re + im * im + 1e-12)
        x = torch.stack([self.band_merge(c) for c in (mag, re, im)], dim=1)  # (B, 3, T, 129)
        x = self.sfe(x)  # (B, 9, T, 129)
        skips = []
        x = self.conv_block("encoder.en0", x)
        skips.append(x)
        x = self.conv_block("encoder.en1", x, groups=2)
        skips.append(x)
        for i, d in zip((2, 3, 4), DILATIONS):
            x = self.gtconv(f"encoder.en{i}", x, d)
            skips.append(x)
        x = self.dpgrnn("dpgrnn2", self.dpgrnn("dpgrnn1", x))
        for i, d in zip((0, 1, 2), reversed(DILATIONS)):
            x = self.gtconv(f"decoder.de{i}", x + skips[4 - i], d)
        x = self.conv_block("decoder.de3", x + skips[1], up=True, groups=2)
        m = self.conv_block("decoder.de4", x + skips[0], up=True, last=True)  # (B, 2, T, 129)
        mr, mi = self.band_split(m[:, 0]), self.band_split(m[:, 1])
        out = torch.stack([re * mr - im * mi, im * mr + re * mi], dim=-1)  # (B, T, F, 2)
        return out.transpose(1, 2)


def forward(P: dict, spec: torch.Tensor, training: bool = False):
    """spec (B, 257, T, 2) float32 -> enhanced spec; in training also the
    BatchNorm batch statistics by path."""
    run = _Run(P, training, None)
    out = run(spec)
    return (out, run.stats) if training else out


# ---------------------------------------------------------------------------
# enhancement around the forward
# ---------------------------------------------------------------------------


def offline_enhance(P: dict, clips: list, device) -> list:
    """Enhanced float32 waveforms of ``clips`` (float32 numpy arrays) with
    ``enhance_wavs``'s semantics (``benchmark/reference/dsp.py``: bucket,
    reflect pad, STFT, forward, iSTFT, trim), one bucket at a time."""
    win = dsp.sqrt_hann(device)
    rows = [dsp.padded_clip(x) for x in clips]
    out: list = [None] * len(clips)
    for size in sorted({len(r) for r in rows}):
        idx = [i for i, r in enumerate(rows) if len(r) == size]
        batch = torch.from_numpy(np.stack([rows[i] for i in idx])).to(device)
        with torch.no_grad():
            wav = dsp.istft(forward(P, dsp.stft(batch, win)), win, length=size).cpu().numpy()
        for k, i in enumerate(idx):
            out[i] = wav[k, :len(clips[i])]
    return out


def stream_enhance(P: dict, audio: torch.Tensor) -> torch.Tensor:
    """The served output of streams fed ``audio`` (S, n_hops * 256) float32
    one hop a step from zero state (``dsp.stream_enhance``'s framing over
    this forward): (S, n_hops * 256), step ``j``'s output at
    ``[256 j, 256 (j + 1))``."""
    S, n = audio.shape
    T, hop = n // dsp.HOP, dsp.HOP
    win = dsp.sqrt_hann(audio.device)
    x = torch.cat([audio.new_zeros((S, hop)), audio], dim=1)
    frames = x.unfold(1, dsp.N_FFT, hop)[:, :T]  # (S, T, 512)
    spec = torch.fft.rfft(frames * win, dim=-1)
    spec = torch.stack([spec.real, spec.imag], dim=-1).transpose(1, 2)  # (S, 257, T, 2)
    with torch.no_grad():
        out = forward(P, spec)
    c = torch.complex(out[..., 0], out[..., 1]).transpose(1, 2)  # (S, T, 257)
    y = torch.fft.irfft(c, n=dsp.N_FFT, dim=-1) * win  # (S, T, 512)
    env = (win * win)[:hop] + (win * win)[hop:]
    prev = torch.cat([y.new_zeros((S, 1, hop)), y[:, :-1, hop:]], dim=1)
    return ((y[..., :hop] + prev) / env).reshape(S, T * hop)
