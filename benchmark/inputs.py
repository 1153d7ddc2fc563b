"""Seeded inputs of the cells, made on the device in a few large calls: the
served streams' audio pool, the DNS3-layout training pairs and the offline
clip set, the last two written as 16-bit wav files under a directory made
by ``tempfile.mkdtemp`` (so under ``TMPDIR``).

The audio is speech-like: a harmonic voice (f0 90-250 Hz with a slow pitch
contour, ten partials falling as 1/h) under a syllabic envelope of 2-6 Hz,
plus white noise at an SNR of 0-20 dB.  It is non-zero everywhere, so every
bin of every frame carries signal.
"""

from __future__ import annotations

import math
import os
import tempfile
import wave

import numpy as np
import torch

FS = 16000


def seed_of(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``."""
    ss = np.random.SeedSequence([seed % (1 << 63), *tag.encode()])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def speech_like(n: int, samples: int, gen: torch.Generator, device,
                snr_db: tuple = (0.0, 20.0), chunk: int = 8192) -> torch.Tensor:
    """(n, samples) float32 audio on ``device``, peak about 0.5."""
    out = torch.empty((n, samples), device=device)
    t = torch.arange(samples, device=device, dtype=torch.float32) / FS
    for lo in range(0, n, chunk):
        c = min(chunk, n - lo)
        r = torch.rand((c, 8), generator=gen, device=device)
        f0 = 90 + 160 * r[:, :1]
        contour = 1 + 0.06 * torch.sin(2 * math.pi * (0.5 + 2 * r[:, 1:2]) * t
                                       + 2 * math.pi * r[:, 2:3])
        phase = torch.cumsum(2 * math.pi * f0 * contour / FS, dim=1)
        voice = torch.zeros((c, samples), device=device)
        for h in range(1, 11):
            voice += torch.sin(h * phase + 2 * math.pi * r[:, 3:4] * h) / h
        env = (0.5 * (1 + torch.sin(2 * math.pi * (2 + 4 * r[:, 4:5]) * t
                                    + 2 * math.pi * r[:, 5:6]))) ** 2
        speech = 0.3 * voice * env / 1.5
        snr = snr_db[0] + (snr_db[1] - snr_db[0]) * r[:, 6:7]
        p = speech.square().mean(dim=1, keepdim=True)
        noise = torch.randn((c, samples), generator=gen, device=device)
        out[lo:lo + c] = speech + noise * torch.sqrt(p / 10 ** (snr / 10))
    return out.clamp_(-0.99, 0.99)


def audio_pool(n_streams: int, hops: int, seed: int, device, dtype) -> torch.Tensor:
    """The served streams' input: (hops, n_streams, 256) in ``dtype``; stream
    ``s`` is fed ``pool[n % hops, s]`` at its ``n``-th step."""
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, "pool"))
    pool = torch.empty((hops, n_streams, 256), device=device, dtype=dtype)
    for lo in range(0, n_streams, 8192):
        c = min(8192, n_streams - lo)
        x = speech_like(c, hops * 256, gen, device)
        pool[:, lo:lo + c] = x.view(c, hops, 256).transpose(0, 1).to(dtype)
    return pool


def write_wav(path: str, pcm: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes(pcm.astype("<i2").tobytes())


def to_pcm(x: torch.Tensor) -> np.ndarray:
    """Float audio -> int16 PCM (host), as a wav writer rounds it."""
    return torch.round(x * 32768).clamp_(-32768, 32767).to(torch.int16).cpu().numpy()


def dns3_pairs(n: int, seconds: float, seed: int, device):
    """``n`` noisy/clean pairs of ``seconds`` in the DNS3 layout
    (``<root>/noisy/<...>_fileid_<i>.wav``, ``<root>/clean/clean_fileid_<i>.wav``);
    noisy is the clean voice plus white noise at -5 to 15 dB.  Returns
    ``(root, noisy_pcm, clean_pcm)`` with the int16 arrays (n, samples)."""
    root = tempfile.mkdtemp(prefix="bench_dns3_")
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, "dns3"))
    samples = int(seconds * FS)
    clean = speech_like(n, samples, gen, device, snr_db=(60.0, 60.0))
    noise = torch.randn((n, samples), generator=gen, device=device)
    snr = -5 + 20 * torch.rand((n, 1), generator=gen, device=device)
    p = clean.square().mean(dim=1, keepdim=True)
    noisy = (clean + noise * torch.sqrt(p / 10 ** (snr / 10))).clamp_(-0.99, 0.99)
    clean_pcm, noisy_pcm = to_pcm(clean), to_pcm(noisy)
    for d in ("noisy", "clean"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        write_wav(os.path.join(root, "noisy", f"synthetic_fileid_{i}.wav"), noisy_pcm[i])
        write_wav(os.path.join(root, "clean", f"clean_fileid_{i}.wav"), clean_pcm[i])
    return root, noisy_pcm, clean_pcm


def clip_set(n_short: int, short_s: tuple, n_long: int, long_s: float, seed: int, device,
             root: str | None = None):
    """``n_short`` clips of lengths spread evenly over ``short_s`` seconds and
    ``n_long`` of ``long_s`` seconds, written as wavs; returns ``(paths,
    pcm arrays)`` in a seeded order.  Every seed has the same lengths (so the
    same buckets and batches), in another order, with other audio."""
    root = root or tempfile.mkdtemp(prefix="bench_clips_")
    rng = np.random.default_rng(seed_of(seed, "clips"))
    lengths = ([int(FS * s) for s in np.linspace(*short_s, n_short)]
               + [int(FS * long_s)] * n_long)
    lengths = [lengths[i] for i in rng.permutation(len(lengths))]
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, "clips"))
    audio = speech_like(len(lengths), max(lengths), gen, device)
    paths, pcms = [], []
    for i, n in enumerate(lengths):
        pcm = to_pcm(audio[i, :n])
        path = os.path.join(root, f"clip_{i:03d}.wav")
        write_wav(path, pcm)
        paths.append(path)
        pcms.append(pcm)
    return paths, pcms
