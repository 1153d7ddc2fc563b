"""STFT / iSTFT with the reference's ``torch.stft`` / ``torch.istft`` semantics.

The reference inlines ``torch.stft(x, 512, 256, 512, window,
return_complex=False)`` (reference gtcrn_micro/train.py:247-263,
infer.py:60-67): ``center=True`` with reflect padding of ``n_fft//2``,
``normalized=False``, ``onesided=True``.  Here that is torch's own transform;
the public layout is the JAX package's ``(..., F, T, 2)``.

Windows are computed in float32 numpy exactly as the JAX package's
``_hann_np`` does, so both packages hold bit-identical windows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
    ``length`` is given.
    """
    if win_len != n_fft:
        raise ValueError("the reference always uses win_len == n_fft")
    if not spec.is_complex():
        spec = torch.view_as_complex(spec.contiguous())
    lead = spec.shape[:-2]
    y = torch.istft(spec.reshape(-1, *spec.shape[-2:]), n_fft, hop_len,
                    win_len, window, center=True, normalized=False,
                    onesided=True, length=length)
    return y.reshape(*lead, y.shape[-1])
