"""DNSMOS (non-intrusive MOS) evaluation on the card (the JAX package's
``eval/dnsmos.py``).

Reference: eval/eval_nonintrusive_dnsmos.py, which wraps the bundled ONNX
models (DNSMOS/sig_bak_ovr.onnx P.835, DNSMOS/model_v8.onnx P.808) via
espnet2 + onnxruntime.  Here the same two models (the port's own copies in
``assets/dnsmos``) run through the port's ONNX executor (``io/onnx.py``) on
the device, and the surrounding algorithm follows the public
microsoft/DNS-Challenge DNSMOS recipe exactly:

- 9.01 s segments hopped by 1 s (repeat-pad shorter clips)
- P.835 model input: raw waveform segment (1, 144160)
- P.808 model input: 120-bin log-mel spectrogram (n_fft 321, hop 160) of the
  segment minus its last hop, scaled (db+40)/40 with ref=max, top_db=80
  (numpy on the host, the JAX package's code)
- polynomial MOS mapping for SIG/BAK/OVRL; mean over segments

The segments of one clip go through each model as one batch (the graphs
reshape with a free batch axis); per segment the numbers equal a loop of
single-segment calls to float32 rounding.

CLI: ``python -m gtcrn_micro_tpu_torch.eval.dnsmos --inf_scp inf.scp
--output_dir RESULTS [--nsplits N --job J] [--device cpu]`` -- output schema
matches the reference (OVRL/SIG/BAK/P808_MOS scp files + RESULTS.txt).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gtcrn_micro_tpu_torch.io.wav import read_wav, resample

METRICS = ("OVRL", "SIG", "BAK", "P808_MOS")
FS = 16000
INPUT_LENGTH = 9.01
# The two scorer models (microsoft/DNS-Challenge public artifacts, bundled
# by the reference in gtcrn_micro/DNSMOS/) are vendored in the port's own
# assets, byte-equal to the JAX package's copies.
DEFAULT_MODEL_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "dnsmos",
)

# MOS polynomial mappings (microsoft/DNS-Challenge dnsmos_local.py)
_P_OVR = np.poly1d([-0.06766283, 1.11546468, 0.04602535])
_P_SIG = np.poly1d([-0.08397278, 1.22083953, 0.0052439])
_P_BAK = np.poly1d([-0.13166888, 1.60915514, -0.39604546])


# ---------------------------------------------------------------------------
# librosa-compatible log-mel spectrogram (librosa is not in this environment)
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asanyarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    mel = np.where(
        log_region,
        min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
        mel,
    )
    return mel


def _mel_to_hz(mel):
    mel = np.asanyarray(mel, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = mel * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mel >= min_log_mel
    return np.where(
        log_region,
        min_log_hz * np.exp(logstep * (mel - min_log_mel)),
        freqs,
    )


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank (librosa.filters.mel)."""
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def audio_melspec(audio: np.ndarray, *, frame_size: int = 320,
                  hop: int = 160, n_mels: int = 120) -> np.ndarray:
    """(T, n_mels) log-mel features, matching the DNSMOS recipe exactly."""
    n_fft = frame_size + 1  # 321 -- the DNSMOS quirk (frame_size+1)
    pad = n_fft // 2
    x = np.pad(audio.astype(np.float64), pad, mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    # scipy-style periodic hann of length n_fft (librosa fftbins=True)
    win = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n_fft) / n_fft))
    frames = x[idx] * win
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2
    mel = spec @ mel_filterbank(FS, n_fft, n_mels).T  # (T, n_mels)
    # power_to_db(ref=np.max, amin=1e-10, top_db=80)
    db = 10 * np.log10(np.maximum(mel, 1e-10))
    db -= 10 * np.log10(np.maximum(mel.max(), 1e-10))
    db = np.maximum(db, db.max() - 80.0)
    return ((db + 40) / 40).astype(np.float32)


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------


def segments(audio: np.ndarray) -> np.ndarray:
    """The (num_hops, 144160) float32 segments the recipe scores: repeat-pad
    to 9.01 s, then 9.01 s windows hopped by 1 s."""
    if len(audio) == 0:  # the repeat-padding below would never end
        raise ValueError("DNSMOS needs at least one sample")
    seg_len = int(INPUT_LENGTH * FS)
    while len(audio) < seg_len:
        audio = np.concatenate([audio, audio])
    num_hops = int(np.floor(len(audio) / FS) - INPUT_LENGTH) + 1
    segs = [audio[i * FS : i * FS + seg_len] for i in range(num_hops)]
    return np.stack([s for s in segs if len(s) == seg_len]).astype(np.float32)


class DnsmosScorer:
    """Callable scoring one waveform -> dict(OVRL, SIG, BAK, P808_MOS)."""

    def __init__(self, model_dir: str = DEFAULT_MODEL_DIR, device=None):
        from gtcrn_micro_tpu_torch.io.onnx import OnnxModel

        self.primary = OnnxModel(os.path.join(model_dir, "sig_bak_ovr.onnx"), device=device)
        self.p808 = OnnxModel(os.path.join(model_dir, "model_v8.onnx"), device=device)
        self.device = self.primary.device

    def raw(self, audio: np.ndarray, fs: int = FS) -> tuple[np.ndarray, np.ndarray]:
        """The models' outputs per segment: P.835 (num_hops, 3) raw
        SIG/BAK/OVRL and P.808 (num_hops,) MOS."""
        if fs != FS:
            audio = resample(audio, fs, FS)
        segs = segments(audio)
        mel = np.stack([audio_melspec(s[:-160]) for s in segs])
        p808 = self.p808(mel)[0][:, 0]
        return self.primary(segs)[0], p808

    def __call__(self, audio: np.ndarray, fs: int = FS) -> dict[str, float]:
        raw, p808 = self.raw(audio, fs)
        sig = [float(_P_SIG(r[0])) for r in raw]
        bak = [float(_P_BAK(r[1])) for r in raw]
        ovr = [float(_P_OVR(r[2])) for r in raw]
        return {
            "OVRL": float(np.mean(ovr)),
            "SIG": float(np.mean(sig)),
            "BAK": float(np.mean(bak)),
            "P808_MOS": float(np.mean([float(p) for p in p808])),
        }


def main(args=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--inf_scp", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--model_dir", default=DEFAULT_MODEL_DIR)
    parser.add_argument("--nsplits", type=int, default=1)
    parser.add_argument("--job", type=int, default=1)
    parser.add_argument("--device", default=None, help="default: cuda")
    ns = parser.parse_args(args)
    scorer = DnsmosScorer(ns.model_dir, device=ns.device)

    pairs = []
    with open(ns.inf_scp) as f:
        for line in f:
            uid, path = line.strip().split(maxsplit=1)
            pairs.append((uid, path))

    # contiguous-range job sharding (reference :56-66)
    size = len(pairs)
    if not 1 <= ns.job <= ns.nsplits <= size:
        parser.error(f"need 1 <= job <= nsplits <= {size} utterances")
    interval = size // ns.nsplits
    start = (ns.job - 1) * interval
    end = size if ns.job == ns.nsplits else start + interval
    pairs = pairs[start:end]
    suffix = "" if ns.nsplits == ns.job == 1 else f".{ns.job}"

    os.makedirs(ns.output_dir, exist_ok=True)
    ret = []
    for i, (uid, path) in enumerate(pairs):
        audio, fs = read_wav(path)
        if audio.ndim > 1:
            audio = audio[:, 0]
        ret.append((uid, scorer(audio, fs)))
        print(f"\rdnsmos {i + 1}/{len(pairs)}", end="", flush=True)
    print()

    for metric in METRICS:
        with open(os.path.join(ns.output_dir, f"{metric}{suffix}.scp"), "w") as f:
            f.writelines(f"{uid} {score[metric]}\n" for uid, score in ret)

    if ns.nsplits == ns.job == 1:
        with open(os.path.join(ns.output_dir, "RESULTS.txt"), "w") as f:
            for metric in METRICS:
                mean = np.nanmean([score[metric] for _, score in ret])
                f.write(f"{metric}: {mean:.4f}\n")
        print(f"Overall results have been written in "
              f"{os.path.join(ns.output_dir, 'RESULTS.txt')}", flush=True)


if __name__ == "__main__":
    main()
