"""Intrusive speech-quality metrics: SDR, SI-SNR, STOI, (optional) PESQ.

A numpy copy of the JAX package's ``eval/metrics.py``, with the port's own
PESQ and resampler; ``tests/test_torch_eval.py`` holds the two equal.

SDR / SI-SNR replicate the reference's definitions exactly
(eval/eval_intrusive_metrics.py:75-91: mean-removed, eps 1e-8).

STOI is a from-spec implementation of the short-time objective
intelligibility measure (Taal et al., 2011) -- the ``pystoi`` package the
reference uses (eval_intrusive_metrics.py:33) is not in this environment.
Parameters match the published algorithm: 10 kHz, 256-sample frames with 50%
overlap, 512-point FFT, 15 one-third-octave bands from 150 Hz, 30-frame
segments, -15 dB clipping, 40 dB silent-frame dynamic range.

PESQ is an ITU-T licensed C implementation; it is gated behind the optional
``pesq`` package exactly like the reference's usage (train.py:17).
"""

from __future__ import annotations

import numpy as np


def sdr_metric(ref: np.ndarray, inf: np.ndarray) -> float:
    """Signal-to-distortion ratio, mean-removed (reference :85-91)."""
    inf = inf - inf.mean()
    ref = ref - ref.mean()
    e_res = inf - ref
    return float(
        10 * np.log10((np.sum(ref**2) + 1e-8) / (np.sum(e_res**2) + 1e-8))
    )


def sisnr_metric(ref: np.ndarray, inf: np.ndarray) -> float:
    """Scale-invariant SNR, mean-removed (reference :75-83)."""
    inf = inf - inf.mean()
    ref = ref - ref.mean()
    a = np.sum(inf * ref) / np.sum(ref**2 + 1e-8)
    e_tgt = a * ref
    e_res = inf - e_tgt
    return float(
        10 * np.log10((np.sum(e_tgt**2) + 1e-8) / (np.sum(e_res**2) + 1e-8))
    )


def pesq_metric(ref: np.ndarray, inf: np.ndarray, fs: int = 16000):
    """Wideband PESQ MOS-LQO.

    Uses the ITU-wrapping ``pesq`` package when importable (bit-identical
    to the reference's usage, train.py:17); otherwise falls back to the
    in-repo from-spec implementation (eval/pesq.py -- property-tested,
    golden-pinned, gated-cross-checked; see its docstring for the
    constants' provenance).  The reference recipe's PESQ column therefore
    always carries a real number in this framework."""
    try:
        from pesq import pesq  # type: ignore

        mode = "nb" if fs == 8000 else "wb"
        return float(pesq(fs, ref, inf, mode))
    except ImportError:
        pass
    except Exception:
        return float("nan")
    try:
        from gtcrn_micro_tpu_torch.eval.pesq import pesq_wb

        if fs != 16000:
            from gtcrn_micro_tpu_torch.io.wav import resample

            ref = resample(ref, fs, 16000)
            inf = resample(inf, fs, 16000)
        return pesq_wb(ref, inf)
    except Exception:
        return float("nan")


# ---------------------------------------------------------------------------
# STOI
# ---------------------------------------------------------------------------

_FS = 10000
_N_FRAME = 256
_NFFT = 512
_NUM_BANDS = 15
_MIN_FREQ = 150.0
_N = 30  # segment length in frames
_BETA = -15.0  # clipping, dB
_DYN_RANGE = 40.0


def _resample_to_10k(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == _FS:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(fs, _FS)
    return resample_poly(x, _FS // g, fs // g)


def _frames(x: np.ndarray, framelen: int, hop: int) -> np.ndarray:
    n = (len(x) - framelen) // hop + 1
    if n <= 0:
        return np.zeros((0, framelen))
    idx = np.arange(n)[:, None] * hop + np.arange(framelen)[None, :]
    return x[idx]


def _remove_silent_frames(x, y, dyn_range, framelen, hop):
    w = np.hanning(framelen + 2)[1:-1]
    xf = _frames(x, framelen, hop) * w
    yf = _frames(y, framelen, hop) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    mask = energies > (np.max(energies) - dyn_range)
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    n_out = (len(xf) - 1) * hop + framelen if len(xf) else 0
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    for i in range(len(xf)):
        xs[i * hop : i * hop + framelen] += xf[i]
        ys[i * hop : i * hop + framelen] += yf[i]
    return xs, ys


def _third_octave_matrix() -> np.ndarray:
    f = np.linspace(0, _FS / 2, _NFFT // 2 + 1)
    obm = np.zeros((_NUM_BANDS, len(f)))
    for i in range(_NUM_BANDS):
        f_mid = _MIN_FREQ * 2 ** (i / 3.0)
        fl = f_mid / 2 ** (1 / 6.0)
        fh = f_mid * 2 ** (1 / 6.0)
        li = int(np.argmin((f - fl) ** 2))
        hi = int(np.argmin((f - fh) ** 2))
        obm[i, li:hi] = 1
    return obm


def stoi_metric(ref: np.ndarray, inf: np.ndarray, fs: int = 16000) -> float:
    """Short-time objective intelligibility in [0, 1]."""
    assert ref.shape == inf.shape
    x = _resample_to_10k(np.asarray(ref, np.float64), fs)
    y = _resample_to_10k(np.asarray(inf, np.float64), fs)
    hop = _N_FRAME // 2
    x, y = _remove_silent_frames(x, y, _DYN_RANGE, _N_FRAME, hop)
    if len(x) < _N_FRAME:
        return float("nan")

    w = np.hanning(_N_FRAME + 2)[1:-1]
    xf = _frames(x, _N_FRAME, hop) * w
    yf = _frames(y, _N_FRAME, hop) * w
    X = np.abs(np.fft.rfft(xf, _NFFT, axis=1)) ** 2  # (T, F)
    Y = np.abs(np.fft.rfft(yf, _NFFT, axis=1)) ** 2

    obm = _third_octave_matrix()
    Xb = np.sqrt(X @ obm.T)  # (T, J)
    Yb = np.sqrt(Y @ obm.T)

    T = Xb.shape[0]
    if T < _N:
        return float("nan")
    clip = 10 ** (-_BETA / 20.0)
    corrs = []
    for m in range(_N, T + 1):
        xs = Xb[m - _N : m].T  # (J, N)
        ys = Yb[m - _N : m].T
        alpha = np.linalg.norm(xs, axis=1, keepdims=True) / (
            np.linalg.norm(ys, axis=1, keepdims=True) + 1e-12
        )
        ys_c = np.minimum(ys * alpha, xs * (1 + clip))
        xm = xs - xs.mean(axis=1, keepdims=True)
        ym = ys_c - ys_c.mean(axis=1, keepdims=True)
        num = np.sum(xm * ym, axis=1)
        den = np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-12
        corrs.append(num / den)
    return float(np.mean(corrs))
