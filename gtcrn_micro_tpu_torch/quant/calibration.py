"""The PTQ calibration set (the JAX package's ``quant/calibration.py``,
reference utils/calibration_data.py).

Reads up to ``n_wavs`` wavs, sqrt-Hann STFTs them at one padded or cut
length of ``max_frames`` frames, computes the global input scale
``2 * p99.99(|x|) * 1.06`` (reference :97-98; shipped value
streaming/tflite/calib_scale.txt = 19.944...) and returns or saves the
normalised ``x / scale + 0.5`` tensor used to calibrate the int8 input.

``calibration_specs`` returns the un-normalised (N, F, T, 2) spec batch that
``quant.ptq.observe_ranges`` takes (the observer derives every layer's range
itself; the global scale is only the model input's quantization step).

``python -m gtcrn_micro_tpu_torch.quant.calibration --wav_dir <dir>``
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gtcrn_micro_tpu_torch.dsp.stft import sqrt_hann_window, stft
from gtcrn_micro_tpu_torch.io.wav import find_wavs, read_wav


def build_calibration(wav_dir: str, n_wavs: int = 300, max_frames: int = 973,
                      out_npy: str | None = None,
                      out_scale: str | None = None) -> tuple[np.ndarray, float]:
    """Returns (normalised (N, T, F, 2) data, scale) like the reference."""
    specs = _load_specs(wav_dir, n_wavs, max_frames, assert_fs=True)
    stacked = specs.transpose(0, 2, 1, 3)  # (N, T, F, 2) like the reference

    scale = float(2.0 * np.percentile(np.abs(stacked), 99.99) * 1.06)
    normalized = np.clip(stacked / scale + 0.5, 0.0, 1.0).astype(np.float32)

    if out_npy:
        os.makedirs(os.path.dirname(out_npy) or ".", exist_ok=True)
        np.save(out_npy, normalized)
    if out_scale:
        with open(out_scale, "w") as f:
            f.write(f"{scale}\n")
    return normalized, scale


def _load_specs(wav_dir: str, n_wavs: int, max_frames: int,
                assert_fs: bool = False) -> np.ndarray:
    """(N, F, T = max_frames, 2) spec batch: the waveforms padded or cut to
    one length, then one batched STFT on the CPU."""
    wavs = sorted(find_wavs(wav_dir))[:n_wavs]
    if not wavs:
        raise FileNotFoundError(f"no wavs under {wav_dir}")
    # n_samples such that n_samples // 256 + 1 == max_frames
    n_samples = (max_frames - 1) * 256
    batch = np.zeros((len(wavs), n_samples), np.float32)
    for i, path in enumerate(wavs):
        x, fs = read_wav(path)
        if x.ndim > 1:
            x = x[:, 0]
        if assert_fs and fs != 16000:
            raise ValueError(f"expected 16 kHz, got {fs} ({path})")
        n = min(len(x), n_samples)
        batch[i, :n] = x[:n]
    window = sqrt_hann_window(512, device="cpu")
    return stft(torch.from_numpy(batch), window).numpy()


def calibration_specs(wav_dir: str, n_wavs: int = 32, max_frames: int = 973) -> np.ndarray:
    """(N, F, T, 2) un-normalised spec batch for ``quant.ptq.observe_ranges``.
    Refuses wavs that are not 16 kHz, as ``build_calibration`` does:
    calibrating on unresampled audio mis-scales every range."""
    return _load_specs(wav_dir, n_wavs, max_frames, assert_fs=True)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--wav_dir", required=True)
    parser.add_argument("--n_wavs", type=int, default=300)
    parser.add_argument("--max_frames", type=int, default=973)
    parser.add_argument("--out_npy", default="calibration.npy")
    parser.add_argument("--out_scale", default="calib_scale.txt")
    ns = parser.parse_args()
    data, scale = build_calibration(ns.wav_dir, ns.n_wavs, ns.max_frames, ns.out_npy,
                                    ns.out_scale)
    print(f"calibration data {data.shape}, scale={scale}")
