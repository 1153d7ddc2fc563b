"""The port's scoring path (gtcrn_micro_tpu_torch.eval: pesq, metrics,
intrusive, evaluate, and infer's checkpoint loader) held against the JAX
package's, on the CPU.

The metric modules are numpy copies, so the same pairs give the same
numbers exactly; intrusive scoring writes the same files byte for byte.
"""

import os

import numpy as np
import pytest

import jax

from gtcrn_micro_tpu.eval import evaluate as jevaluate
from gtcrn_micro_tpu.eval import metrics as jmetrics
from gtcrn_micro_tpu.eval.pesq import pesq_wb as j_pesq_wb
from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu_torch.eval import evaluate, infer, metrics
from gtcrn_micro_tpu_torch.eval.pesq import pesq_wb
from gtcrn_micro_tpu_torch.io.wav import read_wav, write_wav
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, init_params
from gtcrn_micro_tpu_torch.utils.checkpoint import CheckpointManager


def _speechish(n=32000, seed=0):
    """tests/eval/test_metrics.py's modulated multi-tone signal."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    env = 0.5 * (1 + np.sin(2 * np.pi * 4 * t))
    x = sum(np.sin(2 * np.pi * f * t) for f in (220, 440, 880, 1760))
    return (env * x / 4 + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _pair(case):
    x = _speechish()
    noise = np.random.default_rng(1).standard_normal(len(x)).astype(np.float32)
    if case == "noise":
        return x, x + 0.1 * noise
    if case == "gain-noise":  # tests/eval/test_pesq.py::test_gain_invariance
        return x, 3.7 * (x + 0.5 * noise)
    if case == "delay":  # tests/eval/test_pesq.py::test_delay_invariance
        return x, (np.concatenate([np.zeros(700, np.float32), x])[: len(x)]
                   + 0.05 * noise)
    return x, x.copy()


@pytest.mark.parametrize("case", ["noise", "gain-noise", "delay", "identical"])
def test_metrics_equal_jax(case):
    ref, inf = _pair(case)
    assert pesq_wb(ref, inf) == j_pesq_wb(ref, inf)
    for name in ("sdr_metric", "sisnr_metric", "stoi_metric", "pesq_metric"):
        got, want = getattr(metrics, name)(ref, inf), getattr(jmetrics, name)(ref, inf)
        assert got == want or (np.isnan(got) and np.isnan(want)), (name, got, want)


def _scored_dir(root):
    """Two ref/enh pairs and their manifests in ``root`` (the layout of
    tests/test_aux.py::test_evaluate_dispatcher_intrusive)."""
    rng = np.random.default_rng(0)
    root.mkdir()
    lines = {"ref": [], "inf": []}
    for uid in ("a", "b"):
        ref = _speechish(seed=len(lines["ref"]))
        write_wav(str(root / f"{uid}_ref.wav"), ref, 16000)
        write_wav(str(root / f"{uid}_enh.wav"), ref + 0.05 * rng.standard_normal(len(ref)), 16000)
        lines["ref"].append(f"{uid} {root / f'{uid}_ref.wav'}\n")
        lines["inf"].append(f"{uid} {root / f'{uid}_enh.wav'}\n")
    for k, v in lines.items():
        (root / f"{k}.scp").write_text("".join(v))
    cfg = root / "cfg.yaml"
    cfg.write_text(f"network:\n  enh_folder: {root}\n")
    return cfg


def test_intrusive_writes_the_jax_files(tmp_path):
    """evaluate --metric intrusive: the same RESULTS.txt and <METRIC>.scp as
    the JAX package's on the same wavs."""
    for mod, d in ((jevaluate, "jax"), (evaluate, "port")):
        cfg = _scored_dir(tmp_path / d)
        mod.main(["-C", str(cfg), "--metric", "intrusive", "--nj", "1"])
    jout, tout = tmp_path / "jax" / "RESULTS_intrusive", tmp_path / "port" / "RESULTS_intrusive"
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout)) == [
        "PESQ.scp", "RESULTS.txt", "SDR.scp", "SISNR.scp", "STOI.scp"]
    for name in names:
        assert (tout / name).read_text() == (jout / name).read_text().replace(
            str(tmp_path / "jax"), str(tmp_path / "port")), name
    assert all(np.isfinite(float(ln.split()[1]))
               for ln in (tout / "RESULTS.txt").read_text().splitlines()[:4])


def test_evaluate_dnsmos_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        evaluate.main(["--metric", "dnsmos"])


def test_infer_main_loads_a_checkpoint_directory(tmp_path):
    """network.checkpoint may name a CheckpointManager directory: its latest
    step's params enhance the wavs (as enhance_wavs does with them)."""
    params = jax.tree.map(np.asarray, JModel().init(jax.random.PRNGKey(1)))
    older = init_params(device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"params": older, "step": 1})
    mgr.save(2, {"params": GTCRNMicro.from_params(params, device="cpu").params(), "step": 2})
    noisy, clean = tmp_path / "noisy", tmp_path / "clean"
    noisy.mkdir()
    clean.mkdir()
    rng = np.random.default_rng(2)
    for i in (1, 2):
        x = (rng.standard_normal(6000) * 0.3).clip(-1, 1)
        write_wav(str(noisy / f"noisy_fileid_{i}.wav"), x, 16000)
        write_wav(str(clean / f"clean_fileid_{i}.wav"), x, 16000)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"test_dataset:\n  noisy_dir: {noisy}\n  clean_dir: {clean}\n"
                   f"network:\n  checkpoint: {tmp_path / 'ckpt'}\n  enh_folder: {tmp_path / 'enh'}\n")
    infer.main(["-C", str(cfg), "--device", "cpu"])

    model = GTCRNMicro.from_params(params, device="cpu")
    paths = [str(noisy / f"noisy_fileid_{i}.wav") for i in (1, 2)]
    want = infer.enhance_wavs(model, paths, device="cpu", progress=False)
    for p in paths:
        uid = os.path.basename(p)[:-4]
        out, _ = read_wav(str(tmp_path / "enh" / f"{uid}_enh.wav"))
        np.testing.assert_allclose(out, want[p], atol=1 / 32768)
    with pytest.raises(ValueError, match="checkpoint"):  # the .tar is the reference's
        infer.load_params(str(tmp_path / "model.pt"), device="cpu")
