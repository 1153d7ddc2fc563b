"""Mixed 16/8 activation precision for the full-integer deployment path
(the JAX package's ``quant/mixed.py``).

The per-tensor int8 ACTIVATION grid binds the full-int8 artifact's quality,
and AdaRound+LSQ (``quant/adaround.py``) recovers only part of the gap: some
boundaries need more than 256 levels.  This module lifts the few
quality-binding boundaries to int16 while everything else stays int8.
TFLite's 16x8 mode is all-or-nothing (reference scripts/onnx2tf.sh:50-64);
here mixing is an artifact format of its own (GTM8 v2,
``io/export_native.py``) that the native int16 engine runs and the same
fake-quant graph simulates.

Pieces:

- ``greedy_lift``: marginal-gain greedy selection of the boundaries to
  lift, scored by any callable (here the mean SNR against the float32
  pipeline on the distillation train wavs; held-out wavs are never used);
- ``compose_act_qp``: per-path 8/16 ``QParams`` from calibration ranges and
  a lifted set (and learned int8 scales for the unlifted paths);
- ``TracedQuantizer``/``qp_table``: the fake-quantizer over a table of
  device tensors, which the scorer swaps per candidate;
- CLI: the whole pipeline -- deploy calibration, AdaRound+LSQ at int8, the
  greedy lift on the baked artifact, AdaRound again on the mixed grid, GTM8
  v2 export.

``python -m gtcrn_micro_tpu_torch.quant.mixed --checkpoint <ckpt> --wav_dir
<dir with noisy1..5.wav> --out_dir <dir> [--device cpu]``
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Iterable

import numpy as np
import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.quant.fake_quant import QParams, act_qparams, weight_qparams

INT16_BITS = 16
INT8_BITS = 8


def compose_act_qp(ranges: dict[str, tuple[float, float]], lifted: Iterable[str],
                   base_qp: dict[str, QParams] | None = None) -> dict[str, QParams]:
    """Per-path ``QParams``: int16 (from the calibration ranges) at the
    ``lifted`` paths, int8 elsewhere (``base_qp``'s, e.g. LSQ-learned
    scales, when given, else calibrated).  New params are CPU tensors."""
    lifted = set(lifted)
    out: dict[str, QParams] = {}
    for path, (lo, hi) in ranges.items():
        if path in lifted:
            out[path] = act_qparams(np.float32(lo), np.float32(hi), INT16_BITS)
        elif base_qp is not None and path in base_qp:
            out[path] = base_qp[path]
        else:
            out[path] = act_qparams(np.float32(lo), np.float32(hi), INT8_BITS)
    return out


class TracedQuantizer:
    """``ctx.quant`` hook over a table of per-path (scale, zero, qmin, qmax)
    float32 tensors on the data's device: one hook serves every 8/16
    assignment (the JAX package traces the table so that one compiled graph
    does).  No straight-through gradient: it scores, it does not train."""

    def __init__(self, table: dict[str, tuple]):
        self.table = table

    def act(self, path: str, x):
        s, z, qmin, qmax = self.table[path]
        q = torch.clamp(torch.round(x / s) + z, qmin, qmax)
        return (q - z) * s

    def weight(self, path: str, w, channel_axis: int):
        # baked (AdaRounded) weights are already ON their int8 grid, where
        # nearest fake-quant is the identity; raw weights get standard
        # per-channel symmetric int8
        qp = weight_qparams(w, channel_axis)
        return torch.clamp(torch.round(w / qp.scale), -128, 127) * qp.scale


def qp_table(act_qp: dict[str, QParams], device=None) -> dict[str, tuple]:
    """``QParams`` dict -> :class:`TracedQuantizer`'s table on ``device``."""
    dev = resolve_device(device)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32).to(dev)

    return {p: (f32(qp.scale), f32(qp.zero), f32(float(qp.qmin)), f32(float(qp.qmax)))
            for p, qp in act_qp.items()}


def greedy_lift(score_fn: Callable[[set[str]], float], candidates: list[str], target_db: float,
                max_lift: int, log: Callable[[str], None] = print
                ) -> tuple[set[str], float, list[tuple[str, float]]]:
    """Marginal-gain greedy: each round lifts the candidate with the best
    score; stops at ``target_db``, at ``max_lift``, or when no candidate
    helps.  Returns (lifted set, final score, per-round (path, score))."""
    lifted: set[str] = set()
    cur = score_fn(lifted)
    log(f"greedy start: {cur:.2f} dB, target {target_db:.1f} dB")
    trail: list[tuple[str, float]] = []
    remaining = list(candidates)
    while cur < target_db and len(lifted) < max_lift and remaining:
        best_path, best_score = None, cur
        for p in remaining:
            s = score_fn(lifted | {p})
            if s > best_score:
                best_path, best_score = p, s
        if best_path is None:
            log("greedy: no remaining candidate improves the score; stop")
            break
        lifted.add(best_path)
        remaining.remove(best_path)
        cur = best_score
        trail.append((best_path, cur))
        log(f"  lift {best_path:35s} -> {cur:.2f} dB ({len(lifted)}/{max_lift})")
    return lifted, cur, trail


def make_wav_scorer(model, wavs: list[np.ndarray], ranges: dict, base_qp: dict | None):
    """Score a lifted set by the mean waveform SNR over ``wavs`` of the
    mixed fake-quant path against the float32 path of the same ``model``
    (a ``GTCRNMicro`` holding the params to score, on its device)."""
    from gtcrn_micro_tpu_torch.dsp.stft import istft, sqrt_hann_window, stft
    from gtcrn_micro_tpu_torch.quant.parity import snr_db

    dev = model.device
    window = sqrt_hann_window(model.config.win_len, device=dev)
    specs, targets = [], []
    with torch.no_grad():
        for w in wavs:
            spec = stft(torch.from_numpy(np.asarray(w, np.float32)).to(dev)[None], window)
            specs.append(spec)
            targets.append(istft(model.apply(spec), window, length=len(w)).cpu().numpy()[0])

    def score(lifted: set[str]) -> float:
        quant = TracedQuantizer(qp_table(compose_act_qp(ranges, lifted, base_qp), dev))
        vals = []
        with torch.no_grad():
            for w, spec, tgt in zip(wavs, specs, targets):
                out = istft(model.apply(spec, quant=quant), window, length=len(w))
                vals.append(snr_db(tgt, out.cpu().numpy()[0]))
        return float(np.mean(vals))

    return score


def _save_params_npz(params: dict, path: str) -> None:
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import flatten

    np.savez(path, **{k.replace(".", "/"): v.detach().cpu().numpy()
                      for k, v in flatten(params).items()})


def main(args=None) -> None:
    parser = argparse.ArgumentParser(description="mixed 16/8 activation precision pipeline")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--wav_dir", required=True, help="holds the --train_wavs and --held_out")
    parser.add_argument("--train_wavs", default="noisy1,noisy2,noisy3,noisy4")
    parser.add_argument("--held_out", default="noisy5")
    parser.add_argument("--adaround_steps", type=int, default=4000)
    parser.add_argument("--lr_w", type=float, default=0.0,
                        help="train the quantized weights too (QAT x AdaRound); 0 = rounding only")
    parser.add_argument("--w_anchor", type=float, default=0.0)
    parser.add_argument("--post_bias_steps", type=int, default=400)
    parser.add_argument("--target_db", type=float, default=40.0)
    parser.add_argument("--max_lift", type=int, default=8)
    parser.add_argument("--skip_reopt", action="store_true",
                        help="skip the mixed-grid AdaRound re-optimization")
    parser.add_argument("--out_dir", default="gtcrn_mixed")
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(args)
    dev = resolve_device(ns.device)

    from gtcrn_micro_tpu_torch.eval.infer import load_params
    from gtcrn_micro_tpu_torch.io.export_native import export_native_weights_int8
    from gtcrn_micro_tpu_torch.io.params import load_params_npz
    from gtcrn_micro_tpu_torch.io.wav import read_wav
    from gtcrn_micro_tpu_torch.models.folding import fold_bn_params
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro
    from gtcrn_micro_tpu_torch.quant.adaround import (
        adaround_optimize,
        bias_refine,
        deploy_ranges,
        load_act_qp,
        save_act_qp,
    )
    from gtcrn_micro_tpu_torch.quant.qat import build_distill_corpus, enhance_fp32, quant_wav_snr

    model = GTCRNMicro.from_params(fold_bn_params(load_params(ns.checkpoint, device=dev)),
                                   device=dev)
    train_paths = [os.path.join(ns.wav_dir, f"{n}.wav") for n in ns.train_wavs.split(",")]

    def mono(path):
        w, _ = read_wav(path)
        return w[:, 0] if w.ndim > 1 else w

    train_wavs = [mono(p) for p in train_paths]
    held = mono(os.path.join(ns.wav_dir, f"{ns.held_out}.wav"))
    held_t, seen_t = enhance_fp32(model, held), enhance_fp32(model, train_wavs[0])

    def snrs(params, qp):
        m = GTCRNMicro.from_params(params, device=dev)
        return quant_wav_snr(m, qp, train_wavs[0], seen_t), quant_wav_snr(m, qp, held, held_t)

    # 1. deploy calibration ranges (the reference's 973-frame protocol, noisy wavs only)
    ranges = deploy_ranges(model, ns.wav_dir)
    print(f"calibrated {len(ranges)} boundaries", flush=True)
    os.makedirs(ns.out_dir, exist_ok=True)

    def adaround_and_refine(act_qp0):
        baked, qp = adaround_optimize(model, noisy, target, act_qp0, steps=ns.adaround_steps,
                                      reg_weight=2e-3, lr_w=ns.lr_w, w_anchor=ns.w_anchor)
        if ns.post_bias_steps:
            refined = bias_refine(GTCRNMicro.from_params(baked, device=dev), noisy, target, qp,
                                  steps=ns.post_bias_steps)
            if snrs(refined, qp)[1] > snrs(baked, qp)[1]:
                baked = refined
        return baked, qp

    # 2. AdaRound+LSQ at full int8 (cached in out_dir)
    print("building distillation corpus ...", flush=True)
    noisy, target = build_distill_corpus(model, train_paths, stride_seconds=2.0)
    qp8_path = os.path.join(ns.out_dir, "act_qp_int8.npz")
    baked8_path = os.path.join(ns.out_dir, "baked8.npz")
    if os.path.exists(qp8_path) and os.path.exists(baked8_path):
        print("loading cached int8 AdaRound artifact", flush=True)
        qp8, baked8 = load_act_qp(qp8_path, device=dev), load_params_npz(baked8_path, device=dev)
    else:
        baked8, qp8 = adaround_and_refine(compose_act_qp(ranges, lifted=()))
        save_act_qp(qp8, qp8_path)
        _save_params_npz(baked8, baked8_path)
    s1, h1 = snrs(baked8, qp8)
    print(f"int8 AdaRound+LSQ: {ns.train_wavs.split(',')[0]} {s1:.1f} dB, held-out {h1:.1f} dB",
          flush=True)

    # 3. greedy lift on the BAKED artifact (train wavs only)
    score = make_wav_scorer(GTCRNMicro.from_params(baked8, device=dev), train_wavs, ranges, qp8)
    lifted, mixed_score, _trail = greedy_lift(score, list(ranges), ns.target_db, ns.max_lift)
    print(f"lifted {sorted(lifted)} -> train-mean {mixed_score:.1f} dB", flush=True)
    qp_mixed = compose_act_qp(ranges, lifted, qp8)
    s_m, h_m = snrs(baked8, qp_mixed)
    print(f"mixed (no reopt): {s_m:.1f} dB, held-out {h_m:.1f} dB", flush=True)
    best = (baked8, qp_mixed, s_m, h_m)

    # 4. AdaRound again, on the mixed grid
    if not ns.skip_reopt:
        baked_m, qp_m = adaround_and_refine(compose_act_qp(ranges, lifted))
        s_r, h_r = snrs(baked_m, qp_m)
        print(f"mixed (reopt): {s_r:.1f} dB, held-out {h_r:.1f} dB", flush=True)
        if h_r > best[3]:
            best = (baked_m, qp_m, s_r, h_r)

    baked, act_qp, s_fin, h_fin = best
    gtm8 = os.path.join(ns.out_dir, "mixed.gtm8")
    n = export_native_weights_int8(baked, act_qp, gtm8)
    save_act_qp(act_qp, os.path.join(ns.out_dir, "act_qp.npz"))
    _save_params_npz(baked, os.path.join(ns.out_dir, "baked.npz"))
    with open(os.path.join(ns.out_dir, "lifted.txt"), "w") as f:
        f.write("\n".join(sorted(lifted)) + "\n")
    print(f"exported {gtm8} ({n} tensors, {os.path.getsize(gtm8) / 1024:.0f} KB, "
          f"{len(lifted)} int16 boundaries): {s_fin:.1f} dB, held-out {h_fin:.1f} dB", flush=True)


if __name__ == "__main__":
    main()
