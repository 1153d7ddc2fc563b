"""WAV I/O + resampling without soundfile/librosa (not in this environment).

Supports the formats that matter for DNS3/VCTK (16-bit PCM, 32-bit float,
24-bit PCM) with float32 in [-1, 1] semantics matching ``soundfile.read``.
Includes partial reads (``start``/``stop``) like the reference dataloader uses
(dataloader.py:136-162).
"""

from __future__ import annotations

import os
import struct
import wave as _wave
from typing import NamedTuple

import numpy as np


def _header(f, path: str) -> tuple[int, int, int, int, int, int, int]:
    """The RIFF/WAVE header of the open file ``f``: (audio format, channels,
    sample rate, block align, bits, data offset, data bytes)."""
    header = f.read(12)
    if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    fmt = None
    data_off = None
    data_size = None
    while True:
        chunk = f.read(8)
        if len(chunk) < 8:
            break
        cid, csize = struct.unpack("<4sI", chunk)
        if cid == b"fmt ":
            fmt = f.read(csize)
            if csize % 2:
                f.read(1)
        elif cid == b"data":
            data_off = f.tell()
            data_size = csize
            f.seek(csize + (csize % 2), 1)
        else:
            f.seek(csize + (csize % 2), 1)
    if fmt is None or data_off is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    audio_fmt, n_ch, fs, _byte_rate, block_align, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_fmt == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = struct.unpack("<H", fmt[24:26])[0]
    return audio_fmt, n_ch, fs, block_align, bits, data_off, data_size


class WavInfo(NamedTuple):
    """What a wav file's header says of it (:func:`wav_info`)."""

    frames: int
    fs: int
    channels: int
    pcm16: bool  # samples are 16-bit PCM
    data_offset: int


def wav_info(path: str) -> WavInfo:
    """The frames, sample rate, channels and sample format of a wav file,
    from its header alone."""
    with open(path, "rb") as f:
        audio_fmt, n_ch, fs, block_align, bits, data_off, data_size = _header(f, path)
    return WavInfo(data_size // block_align, fs, n_ch, audio_fmt == 1 and bits == 16, data_off)


def read_pcm16_into(path: str, info: WavInfo, out: np.ndarray) -> None:
    """Read the samples of a mono 16-bit PCM wav (``info`` its
    :func:`wav_info`) straight into ``out``, a contiguous int16 array of
    ``info.frames`` samples: the raw samples, as ``read_wav(path,
    dtype=np.int16)`` gives them, without an array of their own."""
    if not (info.pcm16 and info.channels == 1) or out.dtype != np.dtype("<i2") \
            or len(out) != info.frames:
        raise ValueError(f"{path}: {info} does not fit an int16 array of {len(out)} samples")
    with open(path, "rb") as f:
        f.seek(info.data_offset)
        got = f.readinto(memoryview(out).cast("B"))
    if got < out.nbytes:
        raise ValueError(f"truncated wav: {path} header promises {info.frames} frames, "
                         f"file holds {got // 2}")


def read_wav(
    path: str,
    start: int = 0,
    stop: int | None = None,
    dtype=np.float32,
) -> tuple[np.ndarray, int]:
    """Read a wav file -> (samples float32 in [-1,1] shaped (n,) or (n, ch), fs).

    ``start``/``stop`` are in frames, mirroring soundfile.read's behavior.

    ``dtype=np.int16`` returns the RAW 16-bit PCM samples (source must be
    16-bit PCM) — the training data path uses this to halve host->device
    transfer bytes; dequantizing ``int16 / 32768`` on device is bit-exact
    vs the float path here (int16 values are exactly representable in f32
    and the scale is a power of two).
    """
    with open(path, "rb") as f:
        audio_fmt, n_ch, fs, block_align, bits, data_off, data_size = _header(f, path)
        n_frames = data_size // block_align
        stop_f = n_frames if stop is None else min(stop, n_frames)
        start_f = min(start, stop_f)
        count = stop_f - start_f

        f.seek(data_off + start_f * block_align)
        raw = f.read(count * block_align)
        if len(raw) < count * block_align:
            # header claims more than the file holds (truncated download):
            # surface it instead of silently returning short audio
            # (reference surfaces LibsndfileError, dataloader.py:163-168)
            raise ValueError(
                f"truncated wav: {path} header promises {count} frames from "
                f"offset {start_f}, file holds {len(raw) // block_align}"
            )

    if dtype == np.int16:
        if not (audio_fmt == 1 and bits == 16):
            raise ValueError(
                f"dtype=int16 requires 16-bit PCM source, got "
                f"{audio_fmt}/{bits}bit: {path}"
            )
        x = np.frombuffer(raw, dtype="<i2")
        if n_ch > 1:
            x = x.reshape(-1, n_ch)
        return x.astype(np.int16), fs

    if audio_fmt == 1 and bits == 16:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32)
        x /= 32768.0  # in place: no second array of the clip's length
    elif audio_fmt == 1 and bits == 32:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_fmt == 1 and bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / 8388608.0
    elif audio_fmt == 3 and bits == 32:
        x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif audio_fmt == 1 and bits == 8:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported wav format {audio_fmt}/{bits}bit: {path}")

    if n_ch > 1:
        x = x.reshape(-1, n_ch)
    return x.astype(dtype, copy=False), fs


def write_wav(path: str, data: np.ndarray, fs: int) -> None:
    """Write float data in [-1,1] as 16-bit PCM (soundfile's wav default)."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    pcm = np.clip(np.round(data * 32768.0), -32768, 32767).astype("<i2")
    with _wave.open(path, "wb") as w:
        w.setnchannels(data.shape[1])
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(pcm.tobytes())


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (librosa.resample equivalent for our use)."""
    if orig_sr == target_sr:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g).astype(x.dtype)


def find_wavs(root: str) -> list[str]:
    """Recursively find .wav files, sorted (librosa.util.find_files analogue)."""

    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            if fn.lower().endswith(".wav"):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def extract_fileid(path: str) -> str | None:
    """DNS3 pairing token from a noisy filename (reference
    dataloader.py:39-44 / infer.py:17-22) -- the single shared definition."""
    base = os.path.basename(path)
    if "fileid_" not in base:
        return None
    return base.split("fileid_")[-1].split(".")[0]
