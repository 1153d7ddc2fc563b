"""STFT / iSTFT with the reference's ``torch.stft`` / ``torch.istft`` semantics.

The reference inlines ``torch.stft(x, 512, 256, 512, window,
return_complex=False)`` (reference gtcrn_micro/train.py:247-263,
infer.py:60-67): ``center=True`` with reflect padding of ``n_fft//2``,
``normalized=False``, ``onesided=True``.  Here that is torch's own transform;
the public layout is the JAX package's ``(..., F, T, 2)``.

The inverse is ``torch.istft``'s steps written out (:func:`istft_ola`):
``torch.istft`` reads its envelope's minimum back to the host on every
call, while :func:`istft_ola` takes an envelope built, and checked, once
per shape (:func:`ola_envelope`), so that it can run inside a CUDA graph
and leaves the host free while the device runs it.

Windows are computed in float32 numpy exactly as the JAX package's
``_hann_np`` does, so both packages hold bit-identical windows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as tF

from gtcrn_micro_tpu_torch import resolve_device


def _hann_np(win_length: int) -> np.ndarray:
    # torch.hann_window computes in float32; do the same for bit-closeness.
    n = np.arange(win_length, dtype=np.float32)
    w = np.float32(0.5) * (
        np.float32(1.0) - np.cos(np.float32(2.0 * np.pi) * n / np.float32(win_length))
    )
    return w.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """STFT geometry of the reference model: 512/256/512 @ 16 kHz."""

    n_fft: int = 512
    hop_len: int = 256
    win_len: int = 512
    fs: int = 16000

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        return num_samples // self.hop_len + 1


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window, identical to ``torch.hann_window(win_length)``."""
    return torch.from_numpy(_hann_np(win_length)).to(resolve_device(device), dtype)


def sqrt_hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``torch.hann_window(win_length).pow(0.5)``, the inference window; the
    square root is taken in float32."""
    w = np.sqrt(_hann_np(win_length))
    return torch.from_numpy(w).to(resolve_device(device), dtype)


def window_of(kind: str, win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The window a model names: ``"sqrt_hann"`` (GTCRN-Micro, GTCRN) or
    ``"hann"`` (TF-GridNet), periodic."""
    if kind == "sqrt_hann":
        return sqrt_hann_window(win_length, dtype, device)
    if kind == "hann":
        return hann_window(win_length, dtype, device)
    raise ValueError(f"unknown window {kind!r}")


def stft(x: torch.Tensor, window: torch.Tensor, n_fft: int = 512,
         hop_len: int = 256, win_len: int = 512) -> torch.Tensor:
    """STFT of ``x`` (..., num_samples) -> (..., F, T, 2) real/imag."""
    if win_len != n_fft:
        raise ValueError("the reference always uses win_len == n_fft")
    lead = x.shape[:-1]
    spec = torch.stft(x.reshape(-1, x.shape[-1]), n_fft, hop_len, win_len,
                      window, center=True, pad_mode="reflect",
                      normalized=False, onesided=True, return_complex=True)
    spec = torch.view_as_real(spec)  # (N, F, T, 2)
    return spec.reshape(*lead, *spec.shape[1:])


def istft(spec: torch.Tensor, window: torch.Tensor, n_fft: int = 512,
          hop_len: int = 256, win_len: int = 512,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT of (..., F, T, 2) or complex (..., F, T) -> (..., samples).

    ``torch.istft`` semantics: synthesis windowing, overlap-add, squared-window
    envelope normalisation and center trim; length ``hop_len*(T-1)`` unless
    ``length`` is given.  :func:`istft_ola` over an envelope built for this
    call (one read back to the host, as ``torch.istft`` makes).
    """
    if win_len != n_fft or window.shape[0] != n_fft:
        raise ValueError("the reference always uses win_len == n_fft == len(window)")
    T = spec.shape[-1] if spec.is_complex() else spec.shape[-2]
    length = hop_len * (T - 1) if length is None else length
    return istft_ola(spec, window, length, ola_envelope(window, T, length, hop_len), hop_len)


def _overlap_add(frames: torch.Tensor, hop_len: int) -> torch.Tensor:
    """Overlap-add of frames (N, n_fft, T) at ``hop_len`` -> (N, n_fft + hop_len (T - 1))."""
    N, n_fft, T = frames.shape
    full = n_fft + hop_len * (T - 1)
    return tF.fold(frames, (1, full), (1, n_fft), stride=(1, hop_len)).reshape(N, full)


def ola_envelope(window: torch.Tensor, n_frames: int, length: int,
                 hop_len: int = 256) -> torch.Tensor:
    """The envelope :func:`istft_ola` divides by: the squared window
    overlap-added over ``n_frames`` frames and trimmed as ``torch.istft``
    trims it with ``center=True`` to ``length`` samples.  Raises where it
    falls under 1e-11, as ``torch.istft`` does (its one read back to the
    host, made here once for every call that uses the envelope)."""
    n_fft = window.shape[0]
    start = n_fft // 2
    if length > hop_len * (n_frames - 1) + start:
        raise ValueError(f"{length} samples from {n_frames} frames: at most "
                         f"{hop_len * (n_frames - 1) + start}")
    w2 = window.pow(2)[None, :, None].expand(1, n_fft, n_frames)
    env = _overlap_add(w2, hop_len)[0, start : start + length]
    low = env.abs().min()
    if low < 1e-11:
        raise RuntimeError(f"istft(n_fft={n_fft}, hop_length={hop_len}, frames={n_frames}, "
                           f"length={length}): window overlap add min: {float(low)!r}")
    return env


def ola_envelope_rows(window: torch.Tensor, frames: torch.Tensor, n_frames: int,
                      length: int, hop_len: int = 256) -> torch.Tensor:
    """Each row's own :func:`ola_envelope`, (rows, length): the squared
    window overlap-added over the row's first ``frames[r]`` of ``n_frames``
    frames (``frames`` (rows,) int64 on the window's device), as
    ``torch.istft`` builds it for a clip of that many frames alone.  Built on
    the device with no read back to the host; where no frame of a row covers
    a sample (past the row's own end) it is 1, so the zero frames there give
    zeros.  For a Hann or sqrt-Hann window at hop ``n_fft / 2`` it is at
    least 0.5 everywhere else, so it needs no check."""
    n_fft = window.shape[0]
    start = n_fft // 2
    live = torch.arange(n_frames, device=window.device) < frames[:, None]  # (rows, T)
    w2 = window.pow(2)[None, :, None] * live[:, None, :]
    env = _overlap_add(w2, hop_len)[:, start : start + length]
    return torch.where(env > 0, env, 1.0)


def istft_ola(spec: torch.Tensor, window: torch.Tensor, length: int,
              envelope: torch.Tensor, hop_len: int = 256) -> torch.Tensor:
    """:func:`istft` of (..., F, T, 2) or complex (..., F, T) to ``length``
    samples, with the envelope of :func:`ola_envelope` for this T and
    ``length`` (or each row's own, :func:`ola_envelope_rows`):
    ``torch.istft``'s steps (inverse real FFT of ``n_fft = window`` length,
    synthesis window, overlap-add, division by the envelope, centre trim),
    with no read back to the host."""
    if not spec.is_complex():
        spec = torch.view_as_complex(spec.contiguous())
    n_fft = window.shape[0]
    lead = spec.shape[:-2]
    frames = torch.fft.irfft(spec.reshape(-1, *spec.shape[-2:]).transpose(1, 2), n=n_fft)
    frames = (frames * window).transpose(1, 2)  # (N, n_fft, T)
    start = n_fft // 2
    y = _overlap_add(frames, hop_len)[:, start : start + length] / envelope
    return y.reshape(*lead, length)
