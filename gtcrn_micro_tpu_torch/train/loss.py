"""Hybrid spectral + SI-SNR loss (the JAX package's ``train/loss.py``;
reference gtcrn_micro/loss.py:9-71).

- power-law compressed real/imag MSE: real/imag divided by mag^0.7, weight 30;
- compressed magnitude MSE: mag^0.3, weight 70;
- SI-SNR on iSTFT'd waveforms with the *sqrt-Hann* window (reference
  loss.py:50), although the trainer's analysis STFT uses plain Hann
  (train.py:252): the reference's window inconsistency, kept on purpose.

Differentiable with respect to ``pred``; runs on the device inside the
training step.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gtcrn_micro_tpu_torch.dsp.stft import istft, sqrt_hann_window


@functools.lru_cache(maxsize=8)
def _sqrt_hann(win_len: int, device: torch.device) -> torch.Tensor:
    # made once per device: a copy from host memory would wait for the device
    return sqrt_hann_window(win_len, device=device)


@dataclasses.dataclass(frozen=True)
class HybridLossConfig:
    n_fft: int = 512
    hop_len: int = 256
    win_len: int = 512
    compress_factor: float = 0.3
    eps: float = 1e-12
    lamda_ri: float = 30.0
    lamda_mag: float = 70.0


def hybrid_loss(pred_stft: torch.Tensor, true_stft: torch.Tensor,
                config: HybridLossConfig = HybridLossConfig()) -> torch.Tensor:
    """pred/true: (B, F, T, 2) -> scalar loss."""
    pr, pi = pred_stft[..., 0], pred_stft[..., 1]
    tr, ti = true_stft[..., 0], true_stft[..., 1]
    p_mag = torch.sqrt(pr * pr + pi * pi + 1e-12)
    t_mag = torch.sqrt(tr * tr + ti * ti + 1e-12)

    p_c, t_c = p_mag ** 0.7, t_mag ** 0.7
    real_loss = torch.mean(torch.square(pr / p_c - tr / t_c))
    imag_loss = torch.mean(torch.square(pi / p_c - ti / t_c))
    mag_loss = torch.mean(torch.square(p_mag ** config.compress_factor
                                       - t_mag ** config.compress_factor))

    window = _sqrt_hann(config.win_len, pred_stft.device)
    y_pred = istft(pred_stft, window, config.n_fft, config.hop_len, config.win_len)
    y_true = istft(true_stft, window, config.n_fft, config.hop_len, config.win_len)

    # scale-invariant projection (reference loss.py:59-63)
    proj = (torch.sum(y_true * y_pred, dim=-1, keepdim=True) * y_true
            / (torch.sum(torch.square(y_true), dim=-1, keepdim=True) + 1e-8))
    sisnr = -torch.mean(torch.log10(
        torch.sum(torch.square(proj), dim=-1, keepdim=True)
        / (torch.sum(torch.square(y_pred - proj), dim=-1, keepdim=True) + 1e-8)
        + 1e-8))

    return (config.lamda_ri * (real_loss + imag_loss)
            + config.lamda_mag * mag_loss + sisnr)


def si_snr_db(ref: torch.Tensor, est: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR in dB (positive = better), per batch element."""
    ref = ref - ref.mean(dim=-1, keepdim=True)
    est = est - est.mean(dim=-1, keepdim=True)
    proj = (torch.sum(ref * est, dim=-1, keepdim=True) * ref
            / (torch.sum(torch.square(ref), dim=-1, keepdim=True) + eps))
    noise = est - proj
    return 10.0 * torch.log10((torch.sum(torch.square(proj), dim=-1) + eps)
                              / (torch.sum(torch.square(noise), dim=-1) + eps))
