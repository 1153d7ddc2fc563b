"""Plain STFT paths around the reference model: the streamed audio-in ->
audio-out semantics of a served stream, and bulk offline enhancement of
wav clips in bucket-padded batches.

Streamed (the served contract): frame ``t`` covers ``x[256 (t-1) : 256 (t+1)]``
of a stream started from silence (zeros before its first sample); the output
of step ``j`` is ``tail(frame j-1) + head(frame j)`` of the inverse frames
over the squared-window envelope, so it runs one hop behind its input.

Offline (``enhance_wavs`` semantics): each clip goes into a batch padded to
``64 * 2**k >= len // 256 + 1`` frames: the clip, then up to 256 samples of
its tail reflected (``x[n-2], x[n-3], ...``), then zeros; ``center=True``
reflect-padded STFT with the sqrt-Hann window, the eval-mode forward, the
inverse STFT to the padded length, and the clip's own length kept.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import gtcrn

N_FFT, HOP = 512, 256


def sqrt_hann(device) -> torch.Tensor:
    return torch.hann_window(N_FFT, periodic=True, dtype=torch.float64).sqrt().float().to(device)


def hann(device) -> torch.Tensor:
    return torch.hann_window(N_FFT, periodic=True, dtype=torch.float64).float().to(device)


def stft(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """(B, n) -> (B, 257, T, 2), ``center=True`` with reflect padding."""
    s = torch.stft(x, N_FFT, HOP, N_FFT, window, center=True, pad_mode="reflect",
                   normalized=False, onesided=True, return_complex=True)
    return torch.view_as_real(s)


def istft(spec: torch.Tensor, window: torch.Tensor, length: int | None = None) -> torch.Tensor:
    return torch.istft(torch.view_as_complex(spec.contiguous()), N_FFT, HOP, N_FFT, window,
                       center=True, normalized=False, onesided=True, length=length)


def stream_enhance(P: dict, audio: torch.Tensor, rnd=None) -> torch.Tensor:
    """The served output of streams fed ``audio`` (S, n_hops * 256) float32
    one hop a step from zero state: (S, n_hops * 256), step ``j``'s output
    at ``[256 j, 256 (j + 1))``."""
    S, n = audio.shape
    T = n // HOP
    win = sqrt_hann(audio.device)
    x = torch.cat([audio.new_zeros((S, HOP)), audio], dim=1)
    frames = x.unfold(1, N_FFT, HOP)[:, :T]  # (S, T, 512)
    spec = torch.fft.rfft(frames * win, dim=-1)  # (S, T, 257)
    spec = torch.stack([spec.real, spec.imag], dim=-1).transpose(1, 2)  # (S, 257, T, 2)
    out = gtcrn.forward(P, spec, rnd=rnd)
    c = torch.complex(out[..., 0], out[..., 1]).transpose(1, 2)  # (S, T, 257)
    y = torch.fft.irfft(c, n=N_FFT, dim=-1) * win  # (S, T, 512)
    env = (win * win)[:HOP] + (win * win)[HOP:]
    prev = torch.cat([y.new_zeros((S, 1, HOP)), y[:, :-1, HOP:]], dim=1)
    return ((y[..., :HOP] + prev) / env).reshape(S, T * HOP)


def bucket_frames(n_frames: int) -> int:
    b = 64
    while b < n_frames:
        b *= 2
    return b


def padded_clip(x: np.ndarray) -> np.ndarray:
    """A clip as its row of a bucket-padded batch."""
    n = len(x)
    samples = bucket_frames(n // HOP + 1) * HOP
    row = np.zeros(samples, np.float32)
    row[:n] = x
    r = min(HOP, samples - n, n - 1)
    if r > 0:
        row[n:n + r] = x[n - 2 - np.arange(r)]
    return row


def offline_enhance(P: dict, clips: list, device, rnd=None) -> list:
    """Enhanced float32 waveforms of ``clips`` (float32 numpy arrays), one
    bucket at a time."""
    win = sqrt_hann(device)
    rows = [padded_clip(x) for x in clips]
    out: list = [None] * len(clips)
    for size in sorted({len(r) for r in rows}):
        idx = [i for i, r in enumerate(rows) if len(r) == size]
        batch = torch.from_numpy(np.stack([rows[i] for i in idx])).to(device)
        with torch.no_grad():
            enh = gtcrn.forward(P, stft(batch, win), rnd=rnd)
            wav = istft(enh, win, length=size).cpu().numpy()
        for k, i in enumerate(idx):
            out[i] = wav[k, :len(clips[i])]
    return out
