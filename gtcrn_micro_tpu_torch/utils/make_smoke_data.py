"""Generate a tiny synthetic noisy/clean dataset for smoke tests (the JAX
package's ``utils/make_smoke_data.py``: the same bytes for the same seed).

Layout mirrors DNS3 (reference dataloader.py:16-17): ``<root>/{train,val}/
{noisy,clean}/`` with ``fileid_<N>`` pairing tokens in filenames.  Clean =
band-limited tone mixtures, noisy = clean + white noise at ~5 dB SNR.

``python -m gtcrn_micro_tpu_torch.utils.make_smoke_data`` writes the data
``configs/smoke.yaml`` reads.
"""

from __future__ import annotations

import os

import numpy as np

from gtcrn_micro_tpu_torch.io.wav import write_wav


def smoke_pair(rng: np.random.Generator, n: int, fs: int = 16000) -> tuple[np.ndarray, np.ndarray]:
    """One (clean, noisy) float32 pair of ``n`` samples: three tones, white
    noise at 5 dB SNR."""
    t = np.arange(n) / fs
    freqs = rng.uniform(100, 2000, size=3)
    amps = rng.uniform(0.05, 0.2, size=3)
    clean = sum(a * np.sin(2 * np.pi * f * t) for a, f in zip(amps, freqs)).astype(np.float32)
    noise = rng.standard_normal(n).astype(np.float32)
    noise *= np.std(clean) / np.std(noise) / (10 ** (5 / 20))
    return clean, clean + noise


def make_smoke_data(root: str = "/tmp/gtcrn_micro_tpu_smoke", n_train: int = 16,
                    n_val: int = 4, seconds: float = 2.0, fs: int = 16000,
                    seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    for split, count in (("train", n_train), ("val", n_val)):
        noisy_dir = os.path.join(root, split, "noisy")
        clean_dir = os.path.join(root, split, "clean")
        os.makedirs(noisy_dir, exist_ok=True)
        os.makedirs(clean_dir, exist_ok=True)
        for i in range(count):
            clean, noisy = smoke_pair(rng, n, fs)
            # DNS3 naming (reference dataloader.py:39-44, infer.py:83-85):
            # clean_fileid_<N>.wav / noisy_..._fileid_<N>.wav
            write_wav(os.path.join(clean_dir, f"clean_fileid_{i}.wav"), clean, fs)
            write_wav(os.path.join(noisy_dir, f"noisy_{split}_snr5_fileid_{i}.wav"), noisy, fs)
    return root


if __name__ == "__main__":
    print(make_smoke_data())
