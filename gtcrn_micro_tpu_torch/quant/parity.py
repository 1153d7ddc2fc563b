"""Cross-path parity report (the JAX package's ``quant/parity.py``,
reference utils/output_tests.py:10-189).

The reference compares PyTorch, ONNXRuntime and int8 TFLite on one wav.
Here the paths are modes of one graph definition, so the report compares:

- float32 offline against float32 streaming (float error only);
- float32 offline against int8 fake-quant offline (the quantization error);
- int8 offline against int8 streaming (quantized streaming consistency);

plus the enhanced waveform's SNR and the int8-domain output saturation.

``python -m gtcrn_micro_tpu_torch.quant.parity --wav <noisy.wav>
--checkpoint <ckpt> --calib_dir <wav dir> [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.dsp.stft import istft, sqrt_hann_window, stft
from gtcrn_micro_tpu_torch.io.wav import read_wav
from gtcrn_micro_tpu_torch.models.gtcrn_micro import scan_stepper
from gtcrn_micro_tpu_torch.quant.fake_quant import act_qparams, quantize, saturation_fraction


def snr_db(ref: np.ndarray, est: np.ndarray) -> float:
    noise = ref - est
    return float(10 * np.log10((np.sum(ref**2) + 1e-12) / (np.sum(noise**2) + 1e-12)))


def run_parity(model, qmodel, spec: torch.Tensor) -> dict[str, float]:
    """``model`` a float ``GTCRNMicro``, ``qmodel`` its ``QuantizedModel``,
    spec (1, F, T, 2) on their device.  Returns the parity report."""
    window = sqrt_hann_window(512, device=spec.device)
    with torch.no_grad():
        fp32 = model.apply(spec)
        q = qmodel.apply(spec)
        fp32_stream, _ = model.scan_frames(model.init_state(1), spec)
        q_stream, _ = scan_stepper(qmodel.step, qmodel.init_state(1), spec)
        wav_fp32 = istft(fp32, window).cpu().numpy()
        wav_q = istft(q, window).cpu().numpy()
        # int8-domain MAE over the output spec (reference :143-150): both
        # outputs quantized with the float32 output's observed range
        out_qp = act_qparams(fp32.min().cpu(), fp32.max().cpu()).to(spec.device)
        q_fp32 = quantize(fp32, out_qp).to(torch.int32)
        q_q = quantize(q, out_qp).to(torch.int32)
        # fraction of the quantized model's outputs clipped by that range
        # (reference output_tests.py:116-135)
        out_sat = float(saturation_fraction(q, out_qp))
    fp32, q = fp32.cpu().numpy(), q.cpu().numpy()
    return {
        "int8_out_saturation": out_sat,
        "stream_vs_offline_fp32_max": float(np.abs(fp32 - fp32_stream.cpu().numpy()).max()),
        "stream_vs_offline_int8_max": float(np.abs(q - q_stream.cpu().numpy()).max()),
        "fp32_vs_int8_mae": float(np.abs(fp32 - q).mean()),
        "fp32_vs_int8_median_ae": float(np.median(np.abs(fp32 - q))),
        "int8_domain_mae": float((q_fp32 - q_q).abs().float().mean()),
        "enhanced_wav_snr_db": snr_db(wav_fp32, wav_q),
    }


def main(args=None) -> None:
    from gtcrn_micro_tpu_torch.eval.infer import load_params
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro
    from gtcrn_micro_tpu_torch.quant.calibration import calibration_specs
    from gtcrn_micro_tpu_torch.quant.ptq import make_quantized_model

    parser = argparse.ArgumentParser()
    parser.add_argument("--wav", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--calib_dir", required=True)
    parser.add_argument("--n_calib", type=int, default=16)
    parser.add_argument("--act_bits", type=int, default=8, choices=(8, 16))
    parser.add_argument("--percentile", type=float, default=99.99)
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(args)
    dev = resolve_device(ns.device)

    model = GTCRNMicro.from_params(load_params(ns.checkpoint, device=dev), device=dev)
    calib = calibration_specs(ns.calib_dir, n_wavs=ns.n_calib, max_frames=973)
    qmodel = make_quantized_model(model, calib, percentile=ns.percentile, act_bits=ns.act_bits)

    x, _fs = read_wav(ns.wav)
    if x.ndim > 1:
        x = x[:, 0]
    window = sqrt_hann_window(512, device=dev)
    spec = stft(torch.from_numpy(np.asarray(x, np.float32))[None].to(dev), window)
    for k, v in run_parity(model, qmodel, spec).items():
        print(f"{k}: {v:.6g}")


if __name__ == "__main__":
    main()
