"""Bulk offline enhancement (reference infer.py:26-119).

``python -m gtcrn_micro_tpu_torch.eval.infer -C configs/cfg_infer.yaml``

Per wav: read -> resample to 16 kHz -> sqrt-Hann STFT -> the layered model's
offline forward -> iSTFT -> length-match to clean -> write ``<uid>_enh.wav``;
writes the ``inf.scp`` / ``ref.scp`` manifests the reference's eval stack
reads (infer.py:113-119).

As in the JAX package, wavs are padded to power-of-two frame buckets and
batched within a bucket.  Each wav's tail is reflect-padded (torch.stft
``center=True``) before the bucket's zero pad, so a wav enhanced in a batch
matches the wav enhanced alone except for the overlap-add of the padding
frames into its last ~2 hops.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.dsp.stft import istft, sqrt_hann_window, stft
from gtcrn_micro_tpu_torch.io.wav import extract_fileid, read_wav, resample, write_wav

FS = 16000


def _bucket_frames(n_frames: int, min_bucket: int = 64) -> int:
    b = min_bucket
    while b < n_frames:
        b *= 2
    return b


def enhance_wavs(model, wav_paths: list[str], batch_size: int = 8, device=None,
                 progress: bool = True) -> dict[str, np.ndarray]:
    """Enhance wavs with ``model`` (a layered ``GTCRNMicro`` on ``device``,
    or its ``quant.ptq.QuantizedModel``) in bucket-padded batches; returns
    path -> float32 waveform at 16 kHz."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, not on {dev}")
    window = sqrt_hann_window(512, device=dev)

    loaded: list[tuple[str, np.ndarray]] = []
    for p in wav_paths:
        x, fs = read_wav(p)
        if x.ndim > 1:
            x = x[:, 0]
        if fs != FS:
            x = resample(x, fs, FS)
        loaded.append((p, x.astype(np.float32)))

    buckets: dict[int, list[int]] = {}
    for i, (_, x) in enumerate(loaded):
        buckets.setdefault(_bucket_frames(len(x) // 256 + 1), []).append(i)

    out: dict[str, np.ndarray] = {}
    done = 0
    for bucket, idxs in sorted(buckets.items()):
        # a bucket holds wavs of (len // 256 + 1) <= bucket frames, i.e.
        # len < bucket * 256 samples: no tail is cut
        samples = bucket * 256
        for j in range(0, len(idxs), batch_size):
            chunk = idxs[j : j + batch_size]
            batch = np.zeros((len(chunk), samples), np.float32)
            for k, i in enumerate(chunk):
                x = loaded[i][1]
                n = len(x)
                batch[k, :n] = x
                # reflect-pad the true tail: x[n-2], x[n-3], ... (the JAX
                # package's slice x[n-2 : n-2-r : -1] is empty when r = n-1)
                r = min(256, samples - n, n - 1)
                if r > 0:
                    batch[k, n : n + r] = x[n - 2 - np.arange(r)]
            with torch.no_grad():
                spec = stft(torch.from_numpy(batch).to(dev), window)
                enh = model.apply(spec.to(model.dtype)).float()
                wavs = istft(enh, window, length=samples).cpu().numpy()
            for k, i in enumerate(chunk):
                path, x = loaded[i]
                out[path] = wavs[k, : len(x)]
            done += len(chunk)
            if progress:
                print(f"\renhanced {done}/{len(loaded)}", end="", flush=True)
    if progress:
        print()
    return out


def load_params(checkpoint: str, device=None) -> dict:
    """Params from ``checkpoint``: the reference's ``.tar``
    (``io/torch_ckpt.import_reference_checkpoint``), a flat ``.npz`` of
    ``/``-joined param paths (``io/params.load_params_npz``), or a directory
    of the trainer's ``utils/checkpoint.CheckpointManager``, whose latest
    step is read (as the JAX package reads an orbax directory)."""
    from gtcrn_micro_tpu_torch.io.params import load_params_npz, params_from_numpy
    from gtcrn_micro_tpu_torch.io.torch_ckpt import import_reference_checkpoint
    from gtcrn_micro_tpu_torch.utils.checkpoint import CheckpointManager

    if checkpoint.endswith(".tar"):
        return import_reference_checkpoint(checkpoint, device=device)
    if os.path.isdir(checkpoint):
        return params_from_numpy(CheckpointManager(checkpoint).restore()["params"], device)
    if not checkpoint.endswith(".npz"):
        raise ValueError(f"checkpoint {checkpoint!r}: expected the reference .tar, a .npz of "
                         f"params or a checkpoint directory")
    return load_params_npz(checkpoint, device=device)


def write_enhanced(model, noisy_dir: str, clean_dir: str | None, enh_dir: str,
                   batch_size: int = 8, device=None) -> None:
    """Enhance every wav of ``noisy_dir`` into ``enh_dir/<uid>_enh.wav``,
    length-matched to its clean wav in ``clean_dir`` when one is given, and
    write the ``inf.scp`` (and ``ref.scp``) manifests."""
    os.makedirs(enh_dir, exist_ok=True)
    wavs = sorted(os.path.join(noisy_dir, f) for f in os.listdir(noisy_dir)
                  if f.endswith(".wav"))
    enhanced = enhance_wavs(model, wavs, batch_size=batch_size, device=device)

    inf_scp, ref_scp = [], []
    for noisy_path in wavs:
        uid = os.path.basename(noisy_path).split(".wav")[0]
        enh = enhanced[noisy_path]

        if clean_dir is not None:
            fileid = extract_fileid(noisy_path)
            if fileid is None:
                raise RuntimeError(f"Unable to extract fileid: {noisy_path}")
            ref_path = os.path.join(clean_dir, f"clean_fileid_{fileid}.wav")
            if not os.path.exists(ref_path):
                raise FileNotFoundError(ref_path)
            clean, fs_c = read_wav(ref_path)
            if fs_c != FS:
                clean = resample(clean, fs_c, FS)
            # length-match to clean (reference infer.py:98-102)
            if len(enh) < len(clean):
                enh = np.pad(enh, (0, len(clean) - len(enh)))
            else:
                enh = enh[: len(clean)]
            ref_scp.append((uid, ref_path))

        enh_path = os.path.join(enh_dir, uid + "_enh.wav")
        write_wav(enh_path, enh, FS)
        inf_scp.append((uid, enh_path))

    with open(os.path.join(enh_dir, "inf.scp"), "w") as f:
        f.writelines(f"{uid} {p}\n" for uid, p in inf_scp)
    if ref_scp:
        with open(os.path.join(enh_dir, "ref.scp"), "w") as f:
            f.writelines(f"{uid} {p}\n" for uid, p in ref_scp)
    print(f"wrote {len(inf_scp)} enhanced wavs + scp manifests to {enh_dir}")


def main(args=None) -> None:
    """Enhance every wav of the config's ``test_dataset.noisy_dir`` into
    ``network.enh_folder`` with the params of ``network.checkpoint``
    (:func:`load_params`).  ``--quant``: int8 simulated inference (the
    reference's tflite_infer.py): calibrate the activation ranges on 32 wavs
    of ``--calib_dir`` (the noisy dir by default), then enhance with the
    fake-quant model."""
    from gtcrn_micro_tpu_torch.models.registry import get_model
    from gtcrn_micro_tpu_torch.utils.config import load_config

    parser = argparse.ArgumentParser()
    parser.add_argument("-C", "--config", default="configs/cfg_infer.yaml")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--device", default=None)
    parser.add_argument("--quant", action="store_true")
    parser.add_argument("--calib_dir", default=None)
    parser.add_argument("--act_bits", type=int, default=8, choices=(8, 16))
    parser.add_argument("--per_channel_acts", action="store_true",
                        help="per-lane activation scales")
    parser.add_argument("--integer_pc", action="store_true",
                        help="with --per_channel_acts: simulate the full-integer per-channel "
                             "deployment (weight rounding on act-scale-folded tensors)")
    ns = parser.parse_args(args)
    if ns.integer_pc and not ns.per_channel_acts:
        parser.error("--integer_pc requires --per_channel_acts")
    dev = resolve_device(ns.device)
    cfg = load_config(ns.config)

    model = get_model(cfg.get("network_name", "gtcrn_micro"), device=dev,
                      **cfg.get("network_config", {}))
    model.load_params(load_params(cfg["network"]["checkpoint"], device=dev))
    if ns.quant:
        from gtcrn_micro_tpu_torch.quant.calibration import calibration_specs
        from gtcrn_micro_tpu_torch.quant.ptq import make_quantized_model

        calib_dir = ns.calib_dir or cfg["test_dataset"]["noisy_dir"]
        model = make_quantized_model(model, calibration_specs(calib_dir, n_wavs=32),
                                     act_bits=ns.act_bits, per_channel_acts=ns.per_channel_acts,
                                     v4=ns.integer_pc)
        tag = (" per-channel v4" if ns.integer_pc
               else " per-channel" if ns.per_channel_acts else "")
        print(f"int{ns.act_bits}{tag} PTQ model calibrated on {calib_dir}")
    write_enhanced(model, cfg["test_dataset"]["noisy_dir"], cfg["test_dataset"].get("clean_dir"),
                   cfg["network"]["enh_folder"], batch_size=ns.batch_size, device=dev)


if __name__ == "__main__":
    main()
