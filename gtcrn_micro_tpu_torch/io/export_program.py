"""Portable programs through ``torch.export``, and the export CLI: the
counterpart of the JAX package's ``io/export_stablehlo.py`` (StableHLO
through ``jax.export``).

The reference serializes its graph through torch.onnx (opset 16, static
shapes; streaming/conversion/stream_onnx.py:15-129).  Here the portable
artifact is an ``ExportedProgram`` saved by ``torch.export.save`` (a
``.pt2`` file that ``torch.export.load`` reloads on any PyTorch backend), plus
the ONNX files (``io/onnx_export.py``) and the native-runtime weights
(``io/export_native.py``) for the C++ deployment path.

Exports (the weights are the program's own parameters; JAX's programs take
``params`` as their first argument instead):

- offline:   enhanced = f(spec (B, 257, T, 2))
- streaming: (enhanced, state') = f(state, spec (B, 257, 1, 2)), ring state
- audio:     (out, in_buf', ola_buf', state') = f(in_buf, ola_buf, state,
             chunk (B, 256*T)), the served step

The ring state's step counter is a 0-d int64 tensor in a program's state:
``torch.export`` bakes a Python int in as a constant, and a program traced
at counter 0 would read the ring at slot 0 on every hop, right on the
first hop and wrong from the first wrap on.  ``nn/core.py`` reads and
writes the rings by index where the counter is a tensor; the eager path
keeps its int counter and its slices.  :func:`load_exported` accepts
``model.init_state(B)`` as it is (an int counter is made a tensor).

CLI: ``python -m gtcrn_micro_tpu_torch.io.export_program --checkpoint <ckpt>
--out_dir <dir> [--format all|program|onnx|native|native-int8] [--batch 1
--frames 63 --audio_hops 1] [--device cpu]``
"""

from __future__ import annotations

import argparse
import io
import os

import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.io.onnx_export import _Function


def _counter(state: dict, device) -> dict:
    """``state`` with an int ``step`` counter as a 0-d int64 tensor."""
    if isinstance(state.get("step"), int):
        state = dict(state, step=torch.tensor(state["step"], dtype=torch.int64, device=device))
    return state


def _save(fn, args, owner) -> bytes:
    program = torch.export.export(_Function(fn, owner), tuple(args))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _cloned(state: dict) -> dict:
    """A copy of ``state`` for a step to update in place, so that the
    program is a function of its inputs."""
    return {k: v.clone() for k, v in state.items()}


def export_offline(model, batch: int, frames: int) -> bytes:
    """The offline forward of ``model`` (a float32 ``GTCRNMicro``) at static
    shapes, as the bytes of a saved ``ExportedProgram``."""
    spec = torch.zeros((batch, model.config.n_freqs, frames, 2), device=model.device)
    return _save(model.apply, (spec,), model)


def export_streaming(model, batch: int) -> bytes:
    """One streaming step over ring state (tensor counter):
    ``(state, spec) -> (enhanced, state')``."""
    state = _counter(model.init_state(batch), model.device)
    spec = torch.zeros((batch, model.config.n_freqs, 1, 2), device=model.device)

    def step(st, s):
        return model.step(_cloned(st), s)

    return _save(step, (state, spec), model)


def export_audio(model, batch: int, chunk_hops: int = 1, dft: str = "mxu") -> bytes:
    """The served audio-in -> audio-out step (online STFT -> streaming model
    step over ring state -> online iSTFT, ``dsp/stream_dsp.make_audio_step``)
    with its flat signature

        (in_buf (B,256), ola_buf (B,256), model_state, chunk (B, 256*T))
            -> (out_chunk, in_buf', ola_buf', model_state')

    The output runs one hop behind the input; the first emitted chunk is the
    center-trim region (the online-DSP contract).  ``dft``: "mxu" the
    served GEMM-DFT form, "fft" the float32 FFT form."""
    from gtcrn_micro_tpu_torch.dsp import stream_dsp
    from gtcrn_micro_tpu_torch.dsp.stft import sqrt_hann_window

    window = sqrt_hann_window(model.config.win_len, device=model.device)
    step = stream_dsp.make_audio_step(model, window, dft=dft)
    dsp0 = stream_dsp.init_dsp_state(batch, device=model.device)
    state = _counter(model.init_state(batch), model.device)
    chunk = torch.zeros((batch, 256 * chunk_hops), device=model.device)

    def flat_step(in_buf, ola_buf, mstate, c):
        dsp = stream_dsp.DspState(in_buf.clone(), ola_buf.clone())
        out, dsp, ms = step(dsp, _cloned(mstate), c)
        return out, dsp.in_buf, dsp.ola_buf, ms

    return _save(flat_step, (dsp0.in_buf, dsp0.ola_buf, state, chunk), model)


class ExportedStep:
    """A loaded program, called like the function it was exported from.

    A state dict with an int ``step`` counter (``model.init_state``) is
    given a tensor counter on the program's device; the program returns
    its state with the tensor counter, which later calls pass back."""

    def __init__(self, program):
        self.program = program
        self.module = program.module()
        tensors = list(program.state_dict.values()) or list(program.constants.values())
        self.device = tensors[0].device if tensors else torch.device("cpu")

    def __call__(self, *args):
        args = [_counter(a, self.device) if isinstance(a, dict) else a for a in args]
        with torch.no_grad():
            return self.module(*args)


def load_exported(path) -> ExportedStep:
    """Reload a saved program (a path, or the bytes an ``export_*`` gave)."""
    src = io.BytesIO(path) if isinstance(path, (bytes, bytearray)) else path
    return ExportedStep(torch.export.load(src))


def _write(out_dir: str, name: str, blob: bytes) -> None:
    with open(os.path.join(out_dir, name), "wb") as f:
        f.write(blob)


def main(args=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out_dir", default="export")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--frames", type=int, default=63)
    parser.add_argument("--audio_hops", type=int, default=1,
                        help="T (hops per chunk) for the audio-level "
                             "serving-step artifacts (power of two <= 16)")
    parser.add_argument(
        "--format", choices=["all", "program", "onnx", "native", "native-int8"],
        default="all",
        help="program: torch.export programs (.pt2); onnx: opset-16 offline, "
        "streaming-step and audio-step graphs (io/onnx_export.py); native: C++ "
        "runtime weights binary (GTM1 fp32); native-int8: GTM8 quantized artifact "
        "(requires --calib_dir; --act_bits / --per_channel_acts select the "
        "mode -- per-channel emits the v3 layout for the native PC engine)",
    )
    parser.add_argument("--calib_dir", default=None,
                        help="noisy-wav dir for GTM8 activation calibration")
    parser.add_argument("--act_bits", type=int, default=16, choices=(8, 16))
    parser.add_argument("--per_channel_acts", action="store_true")
    parser.add_argument("--integer_pc", action="store_true",
                        help="with --per_channel_acts: GTM8 v4 -- quantize "
                             "each weight on its act-scale-folded tensor so "
                             "the per-channel grid runs full-INTEGER MACs")
    parser.add_argument("--gptq", action="store_true",
                        help="GPTQ weight rounding on the deploy grid with "
                             "an augmented Hessian corpus from --calib_dir "
                             "(quant/gptq.py). Default: nearest.")
    parser.add_argument("--gptq_clips", type=int, default=96,
                        help="augmented Hessian corpus size for --gptq")
    parser.add_argument("--device", default=None, help="default: cuda")
    ns = parser.parse_args(args)
    if ns.format == "native-int8" and not ns.calib_dir:
        parser.error("--format native-int8 requires --calib_dir")
    if ns.integer_pc and not ns.per_channel_acts:
        parser.error("--integer_pc requires --per_channel_acts")
    dev = resolve_device(ns.device)

    from gtcrn_micro_tpu_torch.eval.infer import load_params
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro

    params = load_params(ns.checkpoint, device=dev)
    model = GTCRNMicro.from_params(params, device=dev)
    os.makedirs(ns.out_dir, exist_ok=True)
    produced = []

    if ns.format in ("all", "program"):
        off = export_offline(model, ns.batch, ns.frames)
        _write(ns.out_dir, "gtcrn_micro_offline.pt2", off)
        stream = export_streaming(model, ns.batch)
        _write(ns.out_dir, "gtcrn_micro_stream.pt2", stream)
        audio = export_audio(model, ns.batch, ns.audio_hops)
        _write(ns.out_dir, "gtcrn_micro_audio.pt2", audio)
        produced.append(f"program offline ({len(off)} B) + stream ({len(stream)} B) "
                        f"+ audio step ({len(audio)} B)")

    if ns.format in ("all", "onnx"):
        from gtcrn_micro_tpu_torch.io.onnx_export import (
            export_audio_onnx,
            export_model_onnx,
            export_stream_onnx,
        )

        off = export_model_onnx(model, ns.batch, ns.frames)
        _write(ns.out_dir, "gtcrn_micro.onnx", off)
        stream = export_stream_onnx(model, ns.batch)
        _write(ns.out_dir, "gtcrn_micro_stream.onnx", stream)
        audio = export_audio_onnx(model, ns.batch, ns.audio_hops)
        _write(ns.out_dir, "gtcrn_micro_audio.onnx", audio)
        produced.append(f"onnx offline ({len(off)} B) + stream ({len(stream)} B) "
                        f"+ audio step ({len(audio)} B)")

    if ns.format in ("all", "native"):
        from gtcrn_micro_tpu_torch.io.export_native import export_native_weights

        n = export_native_weights(params, os.path.join(ns.out_dir, "gtcrn_micro_weights.bin"))
        produced.append(f"native weights ({n} tensors)")

    if ns.format == "native-int8":
        # GTM8: BN-folded weights quantized per out-channel + calibrated
        # activation qparams (per-tensor = v1; per-channel = v3)
        import numpy as np

        from gtcrn_micro_tpu_torch.io.export_native import export_native_weights_int8
        from gtcrn_micro_tpu_torch.models.folding import fold_bn_params
        from gtcrn_micro_tpu_torch.quant.calibration import calibration_specs
        from gtcrn_micro_tpu_torch.quant.fake_quant import act_qparams
        from gtcrn_micro_tpu_torch.quant.ptq import observe_ranges

        folded = fold_bn_params(params)
        fmodel = GTCRNMicro.from_params(folded, device=dev)
        calib = calibration_specs(ns.calib_dir, n_wavs=32)
        ranges = observe_ranges(fmodel, calib, batch_size=4, per_channel=ns.per_channel_acts)
        act_qp = {p: act_qparams(np.asarray(lo, np.float32), np.asarray(hi, np.float32),
                                 ns.act_bits).to(dev)
                  for p, (lo, hi) in ranges.items()}
        if ns.gptq:
            from gtcrn_micro_tpu_torch.quant.gptq import augmented_hessian_specs, gptq_params

            hspecs = augmented_hessian_specs(fmodel, ns.calib_dir, n_clips=ns.gptq_clips)
            print(f"GPTQ: augmented Hessian corpus {tuple(hspecs.shape)}; "
                  "sequential rounding over 59 boundaries...", flush=True)
            folded = gptq_params(fmodel, act_qp, hspecs)
        name = ("gtcrn_micro_w8a%d%s%s%s.bin"
                % (ns.act_bits, "_pc" if ns.per_channel_acts else "",
                   "_v4" if ns.integer_pc else "", "_gptq" if ns.gptq else ""))
        n = export_native_weights_int8(folded, act_qp, os.path.join(ns.out_dir, name),
                                       integer_pc=ns.integer_pc)
        ver = ("v4 integer per-channel " if ns.integer_pc
               else "v3 per-channel " if ns.per_channel_acts else "")
        produced.append(f"GTM8 {ver}w8a{ns.act_bits} ({n} tensors, {name})")

    print(f"exported {'; '.join(produced)} to {ns.out_dir}")


if __name__ == "__main__":
    main()
