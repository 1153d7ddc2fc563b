"""Quantization-aware training: recover full-int8 quality by distillation
(the JAX package's ``quant/qat.py``).

Plain PTQ of this model at int8 loses much of its fidelity (the TRA gates
and the decoder have a high dynamic range).  QAT closes the gap:

1. distillation corpus: noisy wavs in, the float32 model's own enhanced
   output as target, so QAT optimises "int8 path == float32 path" and needs
   no clean speech;
2. activation params frozen from PTQ calibration; weight params follow the
   moving weights per channel (straight-through rounding);
3. BatchNorm frozen to the checkpoint's running statistics (``freeze_bn``):
   small fine-tune batches must not drag the statistics the weights were
   trained under.

``python -m gtcrn_micro_tpu_torch.quant.qat --checkpoint <ckpt> --wav_dir
<dir with noisy1.wav ...> --steps 400 --out_dir <dir> [--device cpu]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.dsp.stft import istft, sqrt_hann_window, stft
from gtcrn_micro_tpu_torch.io.wav import read_wav
from gtcrn_micro_tpu_torch.quant.parity import snr_db
from gtcrn_micro_tpu_torch.quant.ptq import FakeQuantizer, observe_ranges, qparams_from_ranges


def _enhance(model, wavs: np.ndarray, length: int, quant=None) -> np.ndarray:
    """Offline enhancement of a (N, samples) stack on the model's device."""
    window = sqrt_hann_window(model.config.win_len, device=model.device)
    with torch.no_grad():
        spec = stft(torch.from_numpy(np.asarray(wavs, np.float32)).to(model.device), window)
        enh = model.apply(spec, quant=quant)
        return istft(enh, window, length=length).cpu().numpy()


def enhance_fp32(model, wav: np.ndarray) -> np.ndarray:
    """Offline float32 enhancement of one wav (the distillation target)."""
    return _enhance(model, wav[None], len(wav))[0]


def build_distill_corpus(model, wav_paths: list[str], segment_seconds: float = 4.0,
                         fs: int = 16000, stride_seconds: float | None = None
                         ) -> tuple[np.ndarray, np.ndarray]:
    """(noisy, target) segment pairs, target = the float32 model's output on
    the whole wav, cut like the noisy segment.  ``stride_seconds`` below
    ``segment_seconds`` gives overlapping crops."""
    seg = int(segment_seconds * fs)
    stride = int((stride_seconds or segment_seconds) * fs)
    noisy_segs, target_segs = [], []
    for path in wav_paths:
        wav, wav_fs = read_wav(path)
        if wav.ndim > 1:
            wav = wav[:, 0]
        if wav_fs != fs:
            raise ValueError(f"{path}: fs {wav_fs} != {fs}")
        target = enhance_fp32(model, wav)
        for s in range(0, len(wav) - seg + 1, stride):
            noisy_segs.append(wav[s : s + seg])
            target_segs.append(target[s : s + seg])
    return np.stack(noisy_segs).astype(np.float32), np.stack(target_segs).astype(np.float32)


def enhance_fp32_batch(model, wavs: np.ndarray, batch: int = 16) -> np.ndarray:
    """Offline float32 enhancement of a (N, samples) stack in batches (the
    distillation targets of a whole corpus)."""
    return np.concatenate([_enhance(model, wavs[i : i + batch], wavs.shape[1])
                           for i in range(0, len(wavs), batch)])


def _pink_noise(rng, n: int) -> np.ndarray:
    """1/f-amplitude noise by spectral shaping of white noise."""
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.fft.rfftfreq(n)
    spec /= np.sqrt(np.maximum(f, f[1]))
    x = np.fft.irfft(spec, n)
    return (x / (np.std(x) + 1e-12)).astype(np.float32)


def _mix_at_snr(rng, speech: np.ndarray, noise: np.ndarray,
                snr_db_lo: float, snr_db_hi: float) -> np.ndarray:
    snr = rng.uniform(snr_db_lo, snr_db_hi)
    p_s = np.mean(speech**2) + 1e-12
    p_n = np.mean(noise**2) + 1e-12
    return speech + noise * np.sqrt(p_s / p_n / 10 ** (snr / 10))


def build_augmented_corpus(model, wav_dir: str, train_ids=(1, 2, 3), val_ids=(4,),
                           n_train: int = 384, n_val: int = 48, segment_seconds: float = 4.0,
                           fs: int = 16000, seed: int = 0):
    """(noisy_tr, target_tr, noisy_val, target_val): an augmented
    distillation corpus from ``noisy{i}.wav`` / ``enh{i}.wav`` pairs in
    ``wav_dir``.  The targets are the float32 model's own outputs, so any
    input is training material: raw noisy crops (the serving distribution),
    enhanced crops (clean proxies) with white or pink noise at SNR U[-5, 20],
    enhanced crops with another wav as interference at U[0, 15], gain-scaled
    noisy crops U[0.25, 2], and tone mixtures in white noise.  The val split
    comes from source wavs disjoint from the train ids."""
    seg = int(segment_seconds * fs)
    rng = np.random.default_rng(seed)

    def load(name):
        w, wav_fs = read_wav(os.path.join(wav_dir, f"{name}.wav"))
        if w.ndim > 1:
            w = w[:, 0]
        if wav_fs != fs:
            raise ValueError(f"{name}: fs {wav_fs} != {fs}")
        return w.astype(np.float32)

    def crop(w):
        if len(w) < seg:
            w = np.tile(w, seg // len(w) + 1)
        s = rng.integers(0, len(w) - seg + 1)
        return w[s : s + seg]

    def clips_for(ids, count):
        noisy_src = [load(f"noisy{i}") for i in ids]
        enh_src = [load(f"enh{i}") for i in ids]
        clips = []
        for _ in range(count):
            r = rng.random()
            k = rng.integers(len(ids))
            if r < 0.25:  # raw serving-distribution crop
                clips.append(crop(noisy_src[k]))
            elif r < 0.50:  # clean proxy + stationary noise
                noise = (_pink_noise(rng, seg) if rng.random() < 0.5
                         else rng.standard_normal(seg).astype(np.float32))
                clips.append(_mix_at_snr(rng, crop(enh_src[k]), noise, -5.0, 20.0))
            elif r < 0.70:  # clean proxy + other-wav interference
                j = (k + 1 + rng.integers(max(len(ids) - 1, 1))) % len(ids)
                clips.append(_mix_at_snr(rng, crop(enh_src[k]), crop(noisy_src[j]), 0.0, 15.0))
            elif r < 0.85:  # gain sweep over the serving distribution
                clips.append(crop(noisy_src[k]) * rng.uniform(0.25, 2.0))
            else:  # synthetic tone mixture (the make_smoke_data recipe)
                t = np.arange(seg) / fs
                clean = sum(a * np.sin(2 * np.pi * f * t)
                            for a, f in zip(rng.uniform(0.05, 0.2, 3),
                                            rng.uniform(100, 2000, 3))).astype(np.float32)
                noise = rng.standard_normal(seg).astype(np.float32)
                clips.append(_mix_at_snr(rng, clean, noise, 0.0, 10.0))
        return np.stack(clips).astype(np.float32)

    noisy_tr = clips_for(train_ids, n_train)
    noisy_val = clips_for(val_ids, n_val)
    return (noisy_tr, enhance_fp32_batch(model, noisy_tr),
            noisy_val, enhance_fp32_batch(model, noisy_val))


def calibrate_act_qparams(model, noisy: np.ndarray, act_bits: int = 8,
                          percentile: float = 99.99) -> dict:
    """Frozen activation params (on the model's device) from the corpus'
    noisy spectra."""
    window = sqrt_hann_window(model.config.win_len, device="cpu")
    specs = stft(torch.from_numpy(np.asarray(noisy, np.float32)), window)
    ranges = observe_ranges(model, specs, batch_size=4, percentile=percentile)
    return qparams_from_ranges(ranges, act_bits, device=model.device)


def qat_finetune(model, noisy: np.ndarray, target: np.ndarray, act_qp: dict, steps: int = 400,
                 batch_size: int = 8, max_lr: float = 2e-4, seed: int = 0,
                 log_every: int = 50) -> list[float]:
    """Fine-tune ``model`` in place through the int8 fake-quant graph (its
    float32 params are the masters).  Returns the losses."""
    from gtcrn_micro_tpu_torch.train.scheduler import WarmupCosineConfig
    from gtcrn_micro_tpu_torch.train.trainer import make_optimizer, make_train_step

    dev = model.device
    opt = make_optimizer(model, WarmupCosineConfig(warmup_steps=max(steps // 20, 1),
                                                   decay_until_step=steps, max_lr=max_lr,
                                                   min_lr=max_lr / 100), device=dev)
    act_qp = {k: qp.to(dev) for k, qp in act_qp.items()}
    step_fn = make_train_step(model, opt, quantizer=FakeQuantizer(act_qp), freeze_bn=True,
                              device=dev)
    rng = np.random.default_rng(seed)
    losses = []
    for i in range(steps):
        idx = rng.choice(len(noisy), size=batch_size, replace=True)
        losses.append(float(step_fn(noisy[idx], target[idx])))
        if log_every and (i + 1) % log_every == 0:
            print(f"  qat step {i + 1}/{steps}  loss {losses[-1]:.4f}")
    return losses


def quant_wav_snr(model, act_qp: dict, wav: np.ndarray, target_wav: np.ndarray) -> float:
    """Enhanced-wav SNR of the int8 fake-quant path against the float32
    target."""
    quant = FakeQuantizer({k: qp.to(model.device) for k, qp in act_qp.items()})
    return snr_db(target_wav, _enhance(model, wav[None], len(wav), quant)[0])


def main(args=None) -> None:
    from gtcrn_micro_tpu_torch.eval.infer import load_params
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, nest
    from gtcrn_micro_tpu_torch.utils.checkpoint import CheckpointManager

    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--wav_dir", required=True,
                        help="directory holding the --train_wavs and --held_out wavs")
    parser.add_argument("--train_wavs", default="noisy1,noisy2,noisy3,noisy4")
    parser.add_argument("--held_out", default="noisy5")
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--max_lr", type=float, default=2e-4)
    parser.add_argument("--act_bits", type=int, default=8, choices=(8, 16))
    parser.add_argument("--out_dir", default="/tmp/gtcrn_qat")
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(args)
    dev = resolve_device(ns.device)

    params = load_params(ns.checkpoint, device=dev)
    model = GTCRNMicro.from_params(params, device=dev)
    train_paths = [os.path.join(ns.wav_dir, f"{n}.wav") for n in ns.train_wavs.split(",")]

    print("building distillation corpus (float32 targets) ...")
    noisy, target = build_distill_corpus(model, train_paths)
    print(f"  {len(noisy)} segments of {noisy.shape[1] / 16000:.0f} s")
    act_qp = calibrate_act_qparams(model, noisy, ns.act_bits)

    def wav_and_target(path):
        wav, _ = read_wav(path)
        wav = wav[:, 0] if wav.ndim > 1 else wav
        return wav, enhance_fp32(model, wav)

    held = wav_and_target(os.path.join(ns.wav_dir, f"{ns.held_out}.wav"))
    # the whole first training wav
    seen = wav_and_target(train_paths[0])
    before = [quant_wav_snr(model, act_qp, *w) for w in (held, seen)]
    print(f"PTQ int{ns.act_bits} SNR vs fp32: held-out {before[0]:.1f} dB, "
          f"train-wav {before[1]:.1f} dB")

    losses = qat_finetune(model, noisy, target, act_qp, steps=ns.steps,
                          batch_size=ns.batch_size, max_lr=ns.max_lr)
    after = [quant_wav_snr(model, act_qp, *w) for w in (held, seen)]
    print(f"QAT int{ns.act_bits} SNR vs fp32: held-out {after[0]:.1f} dB, "
          f"train-wav {after[1]:.1f} dB")
    print(f"loss: first {losses[0]:.4f} -> last {losses[-1]:.4f}")

    # the trainer's checkpoint format, which eval.infer.load_params reads
    params = nest({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
    CheckpointManager(os.path.join(ns.out_dir, "checkpoints")).save(ns.steps, {"params": params})
    print(f"QAT params saved to {ns.out_dir}/checkpoints")


if __name__ == "__main__":
    main()
