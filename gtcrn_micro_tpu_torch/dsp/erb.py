"""ERB filterbank construction, numerically identical to the reference.

The lowest ``erb_subband_1`` (=65) of 257 STFT bins pass through unchanged;
the remaining 192 bins are projected onto ``erb_subband_2`` (=64) triangular
ERB bands and split back with the transpose (reference
gtcrn_micro/models/gtcrn_micro.py:14-73).  The filters are frozen and built
in float32 numpy, so they equal the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gtcrn_micro_tpu_torch import resolve_device


def _hz2erb(freq_hz):
    return 21.4 * np.log10(0.00437 * freq_hz + 1)


def _erb2hz(erb_f):
    return (10 ** (erb_f / 21.4) - 1) / 0.00437


def erb_filter_banks(
    erb_subband_1: int,
    erb_subband_2: int,
    nfft: int = 512,
    high_lim: float = 8000,
    fs: int = 16000,
) -> np.ndarray:
    """Triangular ERB filters, shape (erb_subband_2, nfft//2+1 - erb_subband_1).

    Numerically identical to the reference construction
    (gtcrn_micro/models/gtcrn_micro.py:35-61), including the 1e-12 guards and
    the complementary last band.
    """
    low_lim = erb_subband_1 / nfft * fs
    erb_low = _hz2erb(low_lim)
    erb_high = _hz2erb(high_lim)
    erb_points = np.linspace(erb_low, erb_high, erb_subband_2)
    bins = np.round(_erb2hz(erb_points) / fs * nfft).astype(np.int32)
    erb_filters = np.zeros([erb_subband_2, nfft // 2 + 1], dtype=np.float32)

    erb_filters[0, bins[0] : bins[1]] = (
        bins[1] - np.arange(bins[0], bins[1]) + 1e-12
    ) / (bins[1] - bins[0] + 1e-12)
    for i in range(erb_subband_2 - 2):
        erb_filters[i + 1, bins[i] : bins[i + 1]] = (
            np.arange(bins[i], bins[i + 1]) - bins[i] + 1e-12
        ) / (bins[i + 1] - bins[i] + 1e-12)
        erb_filters[i + 1, bins[i + 1] : bins[i + 2]] = (
            bins[i + 2] - np.arange(bins[i + 1], bins[i + 2]) + 1e-12
        ) / (bins[i + 2] - bins[i + 1] + 1e-12)

    erb_filters[-1, bins[-2] : bins[-1] + 1] = (
        1 - erb_filters[-2, bins[-2] : bins[-1] + 1]
    )

    return np.abs(erb_filters[:, erb_subband_1:])


@dataclasses.dataclass(frozen=True)
class ErbBands:
    """Frozen ERB band merge / split on (..., F) feature tensors."""

    erb_subband_1: int = 65
    erb_subband_2: int = 64
    nfft: int = 512
    high_lim: float = 8000
    fs: int = 16000

    def init_params(self, device=None) -> dict:
        filters = erb_filter_banks(
            self.erb_subband_1, self.erb_subband_2, self.nfft, self.high_lim, self.fs
        )
        dev = resolve_device(device)
        # (n_high_bins, n_bands) so bm/bs are x @ w, as in the JAX package
        return {
            "bm_w": torch.from_numpy(np.ascontiguousarray(filters.T)).to(dev),
            "bs_w": torch.from_numpy(np.ascontiguousarray(filters)).to(dev),
        }

    def bm(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Band merge: (..., F=257) -> (..., 65 + 64 = 129)."""
        lo = x[..., : self.erb_subband_1]
        hi = x[..., self.erb_subband_1 :] @ params["bm_w"]
        return torch.cat([lo, hi], dim=-1)

    def bs(self, params: dict, x_erb: torch.Tensor) -> torch.Tensor:
        """Band split: (..., 129) -> (..., 257)."""
        lo = x_erb[..., : self.erb_subband_1]
        hi = x_erb[..., self.erb_subband_1 :] @ params["bs_w"]
        return torch.cat([lo, hi], dim=-1)
