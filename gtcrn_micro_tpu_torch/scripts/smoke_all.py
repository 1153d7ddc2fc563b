"""End-to-end smoke of every CLI of the port on synthetic data.

Counterpart of the root ``scripts/smoke_all.sh``, in Python: the shell
script's inline steps import PyYAML and JAX, and this one needs neither
(configs are written by ``utils/config.save_config``).  Every step runs in a
process of its own, ``python -m gtcrn_micro_tpu_torch.<module>`` (or
``python -c`` for the two steps that have no CLI), with ``--device`` passed
to each step that touches a device; the first step that fails raises, so
the script exits non-zero.

    python -m gtcrn_micro_tpu_torch.scripts.smoke_all [--root DIR] [--device cpu]

Steps: synthetic data -> train -> infer (f32, then int8 PTQ at 16-bit
activations) -> intrusive evaluation -> export (programs, offline and
streaming ONNX, GTM1 weights) -> the ONNX round trip through
``io/onnx.OnnxModel`` -> GTM8 int8 and 16x8 from the smoke checkpoint ->
the calibrated per-channel GTM8 through the export CLI -> the native
engine's build and its fp32, ``--int8``, ``--int16``, ``--pc`` and
``--bench`` runs -> complexity -> the serving demo on the trained
checkpoint.  The shell script's last step, ``python __graft_entry__.py 8``
(the JAX driver's compile and dry-run contract), has no counterpart here:
``chip_smoke.py`` covers its checks on the card.

``--root`` (default ``/tmp/gtcrn_micro_tpu_smoke``, the shell script's) is
cleared of this script's own outputs first, nothing else in it.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PKG = "gtcrn_micro_tpu_torch"
# what this script writes under --root, and so clears before a run
OUTPUTS = ("train", "val", "enhanced", "export", "smoke.yaml", "cfg_infer.yaml",
           "native_out.wav", "native_out_int8.wav", "native_out_16x8.wav", "native_out_pc.wav",
           "serve_demo.wav")


def _run(cmd: list) -> str:
    """Run ``cmd`` from the repository root, echo its output, and return
    its standard output; raise when it fails."""
    print("$ " + " ".join(map(str, cmd)), flush=True)
    t0 = time.perf_counter()
    res = subprocess.run([str(c) for c in cmd], cwd=REPO, capture_output=True, text=True)
    sys.stdout.write(res.stdout)
    sys.stdout.write(res.stderr)
    if res.returncode:
        raise RuntimeError(f"step failed with exit code {res.returncode}: "
                           + " ".join(map(str, cmd)))
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    return res.stdout


def _module(name: str, *args, device: str | None = None) -> str:
    """``python -m gtcrn_micro_tpu_torch.<name> args [--device device]``."""
    dev = ["--device", device] if device else []
    return _run([sys.executable, "-m", f"{PKG}.{name}", *args, *dev])


def _call(func: str, *args) -> str:
    """``python -c`` calling this module's ``func(*args)`` in a process of
    its own (the shell script's inline steps)."""
    code = f"from {PKG}.scripts.smoke_all import {func}; {func}(*{args!r})"
    return _run([sys.executable, "-c", code])


def _need(path) -> None:
    if not os.path.exists(path):
        raise FileNotFoundError(f"expected output missing: {path}")


def onnx_round_trip(path: str, device: str | None = None) -> None:
    """The emitted offline ONNX re-executes through the port's executor."""
    import numpy as np

    from gtcrn_micro_tpu_torch.io.onnx import OnnxModel

    out = OnnxModel(path, device=device)(np.zeros((1, 257, 8, 2), np.float32))[0]
    out = np.asarray(out)
    if out.shape != (1, 257, 8, 2) or not np.isfinite(out).all():
        raise RuntimeError(f"onnx round trip: shape {out.shape}, finite {np.isfinite(out).all()}")
    print("onnx round-trip ok")


def gtm8_artifacts(checkpoint: str, calib_dir: str, out_dir: str,
                   device: str | None = None) -> None:
    """Quantized GTM8 artifacts (int8 and 16x8) from a checkpoint: BN folded,
    ranges observed on 4 calibration wavs of at most 64 frames."""
    import numpy as np

    from gtcrn_micro_tpu_torch import resolve_device
    from gtcrn_micro_tpu_torch.eval.infer import load_params
    from gtcrn_micro_tpu_torch.io.export_native import export_native_weights_int8
    from gtcrn_micro_tpu_torch.models.folding import fold_bn_params
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro
    from gtcrn_micro_tpu_torch.quant.calibration import calibration_specs
    from gtcrn_micro_tpu_torch.quant.fake_quant import act_qparams
    from gtcrn_micro_tpu_torch.quant.ptq import observe_ranges

    dev = resolve_device(device)
    folded = fold_bn_params(load_params(checkpoint, device=dev))
    calib = calibration_specs(calib_dir, n_wavs=4, max_frames=64)
    ranges = observe_ranges(GTCRNMicro.from_params(folded, device=dev), calib, batch_size=4)
    for bits, name in ((8, "w_int8.bin"), (16, "w_16x8.bin")):
        qp = {p: act_qparams(np.asarray(lo, np.float32), np.asarray(hi, np.float32), bits).to(dev)
              for p, (lo, hi) in ranges.items()}
        export_native_weights_int8(folded, qp, os.path.join(out_dir, name))
    print("GTM8 artifacts ok")


def _clear(root: str) -> None:
    for name in OUTPUTS:
        p = os.path.join(root, name)
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)
    for p in glob.glob(os.path.join(root, "exp_*")):
        shutil.rmtree(p)


def main(argv=None) -> int:
    from gtcrn_micro_tpu_torch import resolve_device
    from gtcrn_micro_tpu_torch.utils.config import load_config, save_config

    parser = argparse.ArgumentParser(description="every CLI of the port, end to end")
    parser.add_argument("--root", default="/tmp/gtcrn_micro_tpu_smoke")
    parser.add_argument("--device", default=None, help="default: cuda")
    ns = parser.parse_args(argv)
    resolve_device(ns.device)  # refuse at once where the steps would find no card
    root, dev = os.path.abspath(ns.root), ns.device
    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    _clear(root)

    _module("utils.make_smoke_data", root)
    cfg = load_config(REPO / "configs" / "smoke.yaml")
    cfg["train_dataset"]["noisy_root"] = f"{root}/train/noisy"
    cfg["valid_dataset"]["noisy_root"] = f"{root}/val/noisy"
    cfg["trainer"]["exp_path"] = f"{root}/exp"
    save_config(cfg, f"{root}/smoke.yaml")
    _module("train.train", "-C", f"{root}/smoke.yaml", device=dev)
    exp = max(glob.glob(f"{root}/exp_*"), key=os.path.getmtime)
    best = f"{exp}/checkpoints/best"

    save_config({"test_dataset": {"noisy_dir": f"{root}/val/noisy",
                                  "clean_dir": f"{root}/val/clean"},
                 "network": {"checkpoint": best, "enh_folder": f"{root}/enhanced"},
                 "network_config": {"n_fft": 512, "hop_len": 256, "win_len": 512}},
                f"{root}/cfg_infer.yaml")
    _module("eval.infer", "-C", f"{root}/cfg_infer.yaml", device=dev)
    _module("eval.infer", "-C", f"{root}/cfg_infer.yaml", "--quant", "--act_bits", "16",
            device=dev)
    _module("eval.evaluate", "-C", f"{root}/cfg_infer.yaml", "--metric", "intrusive",
            "--nj", "2", device=dev)
    _need(f"{root}/enhanced/RESULTS_intrusive/RESULTS.txt")

    export = f"{root}/export"
    _module("io.export_program", "--checkpoint", best, "--out_dir", export, "--frames", "8",
            device=dev)
    for name in ("gtcrn_micro_weights.bin", "gtcrn_micro.onnx", "gtcrn_micro_stream.onnx"):
        _need(f"{export}/{name}")
    _call("onnx_round_trip", f"{export}/gtcrn_micro.onnx", dev)
    _call("gtm8_artifacts", best, f"{root}/val/noisy", export, dev)
    _module("io.export_program", "--checkpoint", best, "--out_dir", export,
            "--format", "native-int8", "--calib_dir", f"{root}/val/noisy", "--act_bits", "16",
            "--per_channel_acts", device=dev)
    _need(f"{export}/gtcrn_micro_w8a16_pc.bin")

    built = _module("runtime.native")
    cli = built.split(" and ")[-1].strip()
    noisy = os.path.join(f"{root}/val/noisy", sorted(os.listdir(f"{root}/val/noisy"))[0])
    _run([cli, f"{export}/gtcrn_micro_weights.bin", noisy, f"{root}/native_out.wav"])
    _run([cli, "--int8", f"{export}/w_int8.bin", noisy, f"{root}/native_out_int8.wav"])
    _run([cli, "--int16", f"{export}/w_16x8.bin", noisy, f"{root}/native_out_16x8.wav"])
    _run([cli, "--pc", f"{export}/gtcrn_micro_w8a16_pc.bin", noisy, f"{root}/native_out_pc.wav"])
    _run([cli, "--bench", f"{export}/gtcrn_micro_weights.bin", "4"])

    _module("utils.complexity", device=dev)
    _module("serve", "--wav", noisy, "--checkpoint", best, "--out", f"{root}/serve_demo.wav",
            "--dtype", "f32", device=dev)
    _need(f"{root}/serve_demo.wav")
    print(f"ALL SMOKE SURFACES OK ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
