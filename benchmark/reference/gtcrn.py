"""Plain GTCRN-Micro: the parameter tree, a seeded initialisation on the
device, and the offline forward in float32, written from the published model
(bglid/GTCRN-Micro, ``gtcrn_micro/models/gtcrn_micro.py``) with plain
``torch`` operations only.

Every temporal op is causal: a left context of zeros, then a valid conv.  So
the forward over T frames equals T streaming steps from zero state, and one
definition serves the streamed, offline and training checks.  Layout inside
is ``(B, C, T, F)``; the parameter tree keeps the published layouts the
program takes (convs HWIO ``(kT, kF, C_in/groups, C_out)``, transposed convs
as flipped-kernel plain convs, pointwise ``(C_in, C_out)``).

``rnd``: a function applied to the spectrum in and out and to every stored
activation (each block's output and each temporal op's input), to compute
the reference in a lower storage precision (the correctness control); None
for float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

C, HALF = 16, 8
N_FREQS, ERB_LO, ERB_BANDS = 257, 65, 64


# ---------------------------------------------------------------------------
# the ERB filterbank (reference gtcrn_micro.py:14-73)
# ---------------------------------------------------------------------------


def erb_filters(sub1: int = ERB_LO, sub2: int = ERB_BANDS, nfft: int = 512,
                high_lim: float = 8000.0, fs: int = 16000) -> np.ndarray:
    """Triangular ERB filters over the bins above ``sub1``: (sub2, nfft//2+1-sub1)."""
    def hz2erb(f):
        return 21.4 * np.log10(0.00437 * f + 1)

    def erb2hz(e):
        return (10 ** (e / 21.4) - 1) / 0.00437

    pts = np.linspace(hz2erb(sub1 / nfft * fs), hz2erb(high_lim), sub2)
    bins = np.round(erb2hz(pts) / fs * nfft).astype(np.int32)
    f = np.zeros([sub2, nfft // 2 + 1], dtype=np.float32)
    f[0, bins[0]:bins[1]] = (bins[1] - np.arange(bins[0], bins[1]) + 1e-12) / (
        bins[1] - bins[0] + 1e-12)
    for i in range(sub2 - 2):
        f[i + 1, bins[i]:bins[i + 1]] = (np.arange(bins[i], bins[i + 1]) - bins[i] + 1e-12) / (
            bins[i + 1] - bins[i] + 1e-12)
        f[i + 1, bins[i + 1]:bins[i + 2]] = (bins[i + 2] - np.arange(bins[i + 1], bins[i + 2])
                                             + 1e-12) / (bins[i + 2] - bins[i + 1] + 1e-12)
    f[-1, bins[-2]:bins[-1] + 1] = 1 - f[-2, bins[-2]:bins[-1] + 1]
    return np.abs(f[:, sub1:])


# ---------------------------------------------------------------------------
# the parameter tree: (path, shape, kind) of every leaf
# ---------------------------------------------------------------------------


def _conv(p, kT, kF, cin_g, cout, bias=True):
    bound = 1.0 / math.sqrt(kT * kF * cin_g)
    out = [(f"{p}.w", (kT, kF, cin_g, cout), ("u", bound))]
    if bias:
        out.append((f"{p}.b", (cout,), ("u", bound)))
    return out


def _pw(p, cin, cout):
    bound = 1.0 / math.sqrt(cin)
    return [(f"{p}.w", (cin, cout), ("u", bound)), (f"{p}.b", (cout,), ("u", bound))]


def _bn(p, c):
    return [(f"{p}.gamma", (c,), ("gamma",)), (f"{p}.beta", (c,), ("beta",)),
            (f"{p}.running_mean", (c,), ("mean",)), (f"{p}.running_var", (c,), ("var",))]


def _act(p):
    return [(f"{p}.alpha", (), ("alpha",))]


def _conv_block(p, cin, cout, last=False):
    return _conv(f"{p}.conv", 1, 5, cin, cout) + _bn(f"{p}.bn", cout) + (
        [] if last else _act(f"{p}.act"))


def _gtconv(p, deconv):
    return (_pw(f"{p}.point_conv1", HALF, C) + _bn(f"{p}.point_bn1", C) + _act(f"{p}.point_act")
            + _conv(f"{p}.depth_conv", 3, 3, C if deconv else 1, C)
            + _bn(f"{p}.depth_bn", C) + _act(f"{p}.depth_act")
            + _pw(f"{p}.point_conv2", C, HALF) + _bn(f"{p}.point_bn2", HALF)
            + [(f"{p}.tra.depth_w", (3, HALF), ("u", 1 / math.sqrt(3))),
               (f"{p}.tra.depth_b", (HALF,), ("u", 1 / math.sqrt(3))),
               (f"{p}.tra.point_w", (HALF, HALF), ("u", 1 / math.sqrt(HALF))),
               (f"{p}.tra.point_b", (HALF,), ("u", 1 / math.sqrt(HALF)))])


def _tcn(p):
    return (_pw(f"{p}.conv1", C, C) + _bn(f"{p}.bn1", C) + _act(f"{p}.act1")
            + _conv(f"{p}.conv2", 3, 1, 1, C) + _bn(f"{p}.bn2", C) + _act(f"{p}.act2")
            + _pw(f"{p}.conv3", C, C) + _bn(f"{p}.bn3", C) + _act(f"{p}.act3"))


def leaf_specs() -> list:
    """Every leaf of the tree except the ERB filters, in a fixed order."""
    specs = [("sfe.depth_conv.w", (1, 3, 1, 3), ("u", 1 / math.sqrt(3)))]
    specs += _conv_block("encoder.en0", 3, C) + _conv_block("encoder.en1", C, C)
    for i in (2, 3, 4):
        specs += _gtconv(f"encoder.en{i}", deconv=False)
    for g in ("gtcn1", "gtcn2"):
        for j in range(4):
            specs += _tcn(f"{g}.block{j}")
    for i in (0, 1, 2):
        specs += _gtconv(f"decoder.de{i}", deconv=True)
    specs += _conv_block("decoder.de3", C, C) + _conv_block("decoder.de4", C, 2, last=True)
    return specs


def is_trainable(path: str) -> bool:
    """The trained leaves: all but the ERB filters and the BatchNorm running
    statistics."""
    return not (path.startswith("erb.") or path.endswith(("running_mean", "running_var")))


def init_params(seed: int, device) -> dict:
    """The flat parameter dict (dotted paths -> float32 tensors on ``device``)
    from ``seed``: one draw of uniforms on the device by a ``torch.Generator``
    there, mapped leaf by leaf to torch's default conv ranges, BatchNorm
    affine near identity (gamma 0.8-1.2, beta within 0.1) and PReLU slopes
    0.15-0.35; then the running statistics of every BatchNorm set to the
    batch statistics of one training-mode forward over 8 speech-like clips
    of 2 s drawn from the same generator.  So every layer works near unit
    scale in eval mode, as in a trained model: the mask is not flat, and a
    stream's output depends on its history (a model at the default ranges
    with identity statistics passes its input through nearly unchanged)."""
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
    win = torch.hann_window(512, periodic=True, dtype=torch.float64).sqrt().float().to(device)
    spec = torch.view_as_real(torch.stft(clips, 512, 256, 512, win, center=True,
                                         pad_mode="reflect", return_complex=True))
    with torch.no_grad(), no_tf32():
        _, stats = forward(out, spec, training=True)
    for p, (mean, var) in stats.items():
        out[f"{p}.running_mean"], out[f"{p}.running_var"] = mean, var
    return out


def nest(flat: dict) -> dict:
    """Dotted paths -> the nested dict the program takes."""
    tree: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


class _Run:
    """One forward: the parameters, the mode and, in training, the batch
    statistics it records (path -> (mean, unbiased variance))."""

    def __init__(self, P: dict, training: bool, rnd):
        self.P, self.training, self.stats = P, training, {}
        self.rnd = rnd or (lambda x: x)

    def bn(self, p, x):
        P = self.P
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
            n = x.numel() // x.shape[1]
            self.stats[p] = (mean.detach(), (var * n / (n - 1)).detach())
        else:
            mean, var = P[f"{p}.running_mean"], P[f"{p}.running_var"]
        scale = P[f"{p}.gamma"] / torch.sqrt(var + 1e-5)
        return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                + P[f"{p}.beta"][None, :, None, None])

    def prelu(self, p, x):
        a = self.P[f"{p}.alpha"]
        return torch.where(x >= 0, x, a * x)

    def pw(self, p, x):
        return (torch.einsum("bctf,cd->bdtf", x, self.P[f"{p}.w"])
                + self.P[f"{p}.b"][None, :, None, None])

    def conv(self, p, x, *, dil_t=1, pad_f=0, stride_f=1, groups=1, up=1, bias=True):
        """Causal-in-time conv of x (B, C, T, F); ``up`` 2 is the transposed
        frequency conv (zeros stuffed between bins, then a plain conv)."""
        w = self.P[f"{p}.w"]
        kT, kF = w.shape[0], w.shape[1]
        if up > 1:
            B, Cc, T, Fq = x.shape
            z = x.new_zeros((B, Cc, T, (Fq - 1) * up + 1))
            z[..., ::up] = x
            x, pad_f = z, (kF - 1) - pad_f
        if kT > 1:
            x = F.pad(self.rnd(x), (0, 0, (kT - 1) * dil_t, 0))
        b = self.P[f"{p}.b"] if bias else None
        return F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=(1, stride_f),
                        padding=(0, pad_f), dilation=(dil_t, 1), groups=groups)

    def conv_block(self, p, x, up=False, last=False):
        y = self.bn(f"{p}.bn", self.conv(f"{p}.conv", x, pad_f=2, stride_f=1 if up else 2,
                                         up=2 if up else 1))
        return torch.tanh(y) if last else self.prelu(f"{p}.act", y)

    def tra(self, p, h):
        P = self.P
        e = self.rnd((h * h).mean(dim=3))  # (B, C, T)
        T = e.shape[2]
        ep = F.pad(e, (2, 0))
        w = P[f"{p}.depth_w"]
        y = P[f"{p}.depth_b"][None, :, None] + sum(ep[:, :, i:i + T] * w[i][None, :, None]
                                                   for i in range(3))
        g = torch.sigmoid(torch.einsum("bct,cd->bdt", y, P[f"{p}.point_w"])
                          + P[f"{p}.point_b"][None, :, None])
        return h * g[..., None]

    def gtconv(self, p, x, deconv):
        x1, x2 = x[:, :HALF], x[:, HALF:]
        h = self.prelu(f"{p}.point_act", self.bn(f"{p}.point_bn1", self.pw(f"{p}.point_conv1", x1)))
        h = self.conv(f"{p}.depth_conv", h, pad_f=1, groups=1 if deconv else C)
        h = self.prelu(f"{p}.depth_act", self.bn(f"{p}.depth_bn", h))
        h = self.bn(f"{p}.point_bn2", self.pw(f"{p}.point_conv2", h))
        h = self.tra(f"{p}.tra", h)
        return torch.stack([h, x2], dim=2).flatten(1, 2)  # out[2c] = h[c], out[2c+1] = x2[c]

    def tcn(self, p, x, d):
        y = self.prelu(f"{p}.act1", self.bn(f"{p}.bn1", self.pw(f"{p}.conv1", x)))
        y = self.prelu(f"{p}.act2", self.bn(f"{p}.bn2", self.conv(f"{p}.conv2", y, dil_t=d,
                                                                  groups=C)))
        y = self.bn(f"{p}.bn3", self.pw(f"{p}.conv3", y))
        return self.prelu(f"{p}.act3", y + x)

    def band_merge(self, x):
        return torch.cat([x[..., :ERB_LO], x[..., ERB_LO:] @ self.P["erb.bm_w"]], dim=-1)

    def band_split(self, x):
        return torch.cat([x[..., :ERB_LO], x[..., ERB_LO:] @ self.P["erb.bs_w"]], dim=-1)

    def __call__(self, spec):
        r = self.rnd
        spec = r(spec)
        re, im = spec[..., 0].transpose(1, 2), spec[..., 1].transpose(1, 2)  # (B, T, F)
        mag = torch.sqrt(re * re + im * im + 1e-12)
        x = torch.stack([self.band_merge(c) for c in (mag, re, im)], dim=1)  # (B, 3, T, 129)
        x = self.conv("sfe.depth_conv", x, pad_f=1, groups=3, bias=False)
        skips = []
        x = r(self.conv_block("encoder.en0", x))
        skips.append(x)
        x = r(self.conv_block("encoder.en1", x))
        skips.append(x)
        for i in (2, 3, 4):
            x = r(self.gtconv(f"encoder.en{i}", x, deconv=False))
            skips.append(x)
        for g in ("gtcn1", "gtcn2"):
            for j in range(4):
                x = r(self.tcn(f"{g}.block{j}", x, 2 ** j))
        for i in (0, 1, 2):
            x = r(self.gtconv(f"decoder.de{i}", x + skips[4 - i], deconv=True))
        x = r(self.conv_block("decoder.de3", x + skips[1], up=True))
        m = self.conv_block("decoder.de4", x + skips[0], up=True, last=True)  # (B, 2, T, 129)
        mr, mi = self.band_split(m[:, 0]), self.band_split(m[:, 1])
        out = torch.stack([re * mr - im * mi, im * mr + re * mi], dim=-1)  # (B, T, F, 2)
        return r(out.transpose(1, 2))


def forward(P: dict, spec: torch.Tensor, training: bool = False, rnd=None):
    """spec (B, 257, T, 2) float32 -> enhanced spec; in training also the
    BatchNorm batch statistics by path."""
    run = _Run(P, training, rnd)
    out = run(spec)
    return (out, run.stats) if training else out


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
