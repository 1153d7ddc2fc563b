"""The port's quantization pipeline (gtcrn_micro_tpu_torch.quant.qat,
calibration, parity; eval.infer --quant) held against the JAX package's on
temporary wavs, on the CPU.

The same numpy params (the JAX init, PRNGKey(0)) and the same wavs go into
both; where a step takes activation params, JAX's are carried across bit for
bit, so the two sides quantize on one grid.  Tolerances and why:

- audio through the float32 model (distillation targets): atol 1e-5, the
  layered spectra's bound (tests/test_torch_layered.py), measured 2e-7;
- STFT-domain calibration data: atol 1e-6 on values in [0, 1] and the scale
  rtol 1e-6 (the two STFTs differ by float32 rounding, measured 1e-7);
- calibrated params from each side's own observer: scales rtol 1e-6 and zero
  points within 1 (the ranges differ by the forwards' rounding,
  tests/test_torch_quant.py);
- numbers of the int8 fake-quant path (SNR in dB, MAEs, the QAT losses): an
  int8 value on a rounding tie may flip by one quantum between the two
  forwards, so SNRs within 0.1 dB, MAEs and saturation rtol 1e-2, losses
  rtol 1e-5 (measured: the same digits).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.io.wav import write_wav as j_write_wav
from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu.quant import calibration as jcal
from gtcrn_micro_tpu.quant import parity as jparity
from gtcrn_micro_tpu.quant import qat as jqat
from gtcrn_micro_tpu.quant.ptq import make_quantized_model as j_make_quantized_model
from gtcrn_micro_tpu_torch.eval import infer
from gtcrn_micro_tpu_torch.io.params import act_qp_from_jax
from gtcrn_micro_tpu_torch.io.wav import read_wav
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, flatten
from gtcrn_micro_tpu_torch.quant import calibration, parity, qat
from gtcrn_micro_tpu_torch.quant.ptq import QuantizedModel, make_quantized_model


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module's small tensors (the suite runs
    several workers on the host's cores), the caller's count restored."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jm = JModel()
    params = jm.init(jax.random.PRNGKey(0))
    pnp = jax.tree.map(np.asarray, params)
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(11)
    paths = []
    for i in range(2):  # tests/quant/test_quant.py:196-254's two 2 s wavs
        p = str(d / f"n{i}.wav")
        j_write_wav(p, (rng.standard_normal(32000) * 0.1).astype(np.float32), 16000)
        paths.append(p)
    return jm, params, pnp, paths, d


def _model(pnp):
    return GTCRNMicro.from_params(pnp, device="cpu")


def test_qat_pipeline_matches_jax(setup):
    """Distillation corpus, calibration, the quality probe and two QAT steps
    (tests/quant/test_quant.py::test_qat_pipeline_functions) against JAX's."""
    jm, params, pnp, paths, _ = setup
    noisy_j, target_j = jqat.build_distill_corpus(jm, params, paths, segment_seconds=1.0)
    model = _model(pnp)
    noisy, target = qat.build_distill_corpus(model, paths, segment_seconds=1.0)
    assert noisy.shape == target.shape == (4, 16000)
    np.testing.assert_array_equal(noisy, noisy_j)
    np.testing.assert_allclose(target, target_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(qat.enhance_fp32(model, noisy[0]),
                               jqat.enhance_fp32(jm, params, noisy[0]), rtol=0, atol=1e-5)

    act_qp_j = jqat.calibrate_act_qparams(jm, params, noisy, act_bits=8)
    act_qp = qat.calibrate_act_qparams(model, noisy, act_bits=8)
    assert set(act_qp) == set(act_qp_j) and len(act_qp) == 59
    for k, qp in act_qp_j.items():
        np.testing.assert_allclose(act_qp[k].scale.numpy(), np.asarray(qp.scale), rtol=1e-6)
        assert abs(float(act_qp[k].zero) - float(qp.zero)) <= 1, k

    carried = act_qp_from_jax(act_qp_j, device="cpu")
    snr_j = jqat.quant_wav_snr(jm, params, act_qp_j, noisy[0], target_j[0])
    snr = qat.quant_wav_snr(model, carried, noisy[0], target[0])
    assert np.isfinite(snr) and abs(snr - snr_j) <= 0.1, (snr, snr_j)

    _, losses_j = jqat.qat_finetune(jm, params, noisy_j, target_j, act_qp_j, steps=2,
                                    batch_size=2, max_lr=1e-4, log_every=0)
    losses = qat.qat_finetune(model, noisy, target, carried, steps=2, batch_size=2,
                              max_lr=1e-4, log_every=0)
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    assert np.isfinite(qat.quant_wav_snr(model, carried, noisy[0], target[0]))


def test_augmented_corpus_matches_jax(setup, tmp_path):
    jm, params, pnp, _, _ = setup
    rng = np.random.default_rng(12)
    for i in (1, 2):
        for kind in ("noisy", "enh"):
            j_write_wav(str(tmp_path / f"{kind}{i}.wav"),
                        (rng.standard_normal(20000) * 0.1).astype(np.float32), 16000)
    kw = dict(train_ids=(1,), val_ids=(2,), n_train=6, n_val=2, segment_seconds=0.5, seed=3)
    want = jqat.build_augmented_corpus(jm, params, str(tmp_path), **kw)
    got = qat.build_augmented_corpus(_model(pnp), str(tmp_path), **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        if i % 2 == 0:  # the noisy clips: the same numpy arithmetic
            np.testing.assert_array_equal(g, w)
        else:  # the float32 model's targets
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_build_calibration_matches_jax(setup, tmp_path):
    *_, paths, d = setup
    data_j, scale_j = jcal.build_calibration(str(d), n_wavs=2, max_frames=40)
    out_npy, out_scale = str(tmp_path / "c" / "calib.npy"), str(tmp_path / "scale.txt")
    data, scale = calibration.build_calibration(str(d), n_wavs=2, max_frames=40,
                                                out_npy=out_npy, out_scale=out_scale)
    assert data.shape == data_j.shape == (2, 40, 257, 2) and data.dtype == np.float32
    np.testing.assert_allclose(scale, scale_j, rtol=1e-6)
    np.testing.assert_allclose(data, data_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.load(out_npy), data)
    assert float(open(out_scale).read()) == scale
    specs = calibration.calibration_specs(str(d), n_wavs=2, max_frames=40)
    np.testing.assert_allclose(specs, jcal.calibration_specs(str(d), n_wavs=2, max_frames=40),
                               rtol=0, atol=1e-5)
    with pytest.raises(FileNotFoundError):
        calibration.calibration_specs(str(tmp_path / "empty"), n_wavs=2)


def test_run_parity_matches_jax(setup):
    jm, params, pnp, _, _ = setup
    calib = np.random.default_rng(0).standard_normal((4, 257, 16, 2)).astype(np.float32) * 0.3
    spec = np.random.default_rng(1).standard_normal((1, 257, 6, 2)).astype(np.float32) * 0.3
    qm_j = j_make_quantized_model(jm, params, jnp.asarray(calib), batch_size=4)
    want = jparity.run_parity(jm, params, qm_j, jnp.asarray(spec))
    model = _model(pnp)
    got = parity.run_parity(model, QuantizedModel(model, act_qp_from_jax(qm_j.act_qp, "cpu")),
                            torch.from_numpy(spec))
    assert set(got) == set(want)
    assert got["stream_vs_offline_fp32_max"] < 1e-6
    # the int8 streaming gap: at most a tie flip (tests/test_torch_quant.py)
    assert got["stream_vs_offline_int8_max"] < 5e-3
    assert abs(got["enhanced_wav_snr_db"] - want["enhanced_wav_snr_db"]) <= 0.1
    for k in ("fp32_vs_int8_mae", "fp32_vs_int8_median_ae", "int8_domain_mae",
              "int8_out_saturation"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, err_msg=k)
    assert parity.snr_db(np.ones(4), np.ones(4)) == jparity.snr_db(np.ones(4), np.ones(4))


def test_infer_main_quant(setup, tmp_path):
    """``infer.main --quant`` calibrates on the noisy dir and enhances with
    the fake-quant model, as the pipeline's parts do."""
    _, _, pnp, _, _ = setup
    np.savez(tmp_path / "params.npz",
             **{k.replace(".", "/"): np.asarray(v) for k, v in flatten(pnp).items()})
    noisy = tmp_path / "noisy"
    noisy.mkdir()
    rng = np.random.default_rng(2)
    for i in (1, 2):
        j_write_wav(str(noisy / f"noisy_fileid_{i}.wav"),
                    (rng.standard_normal(6000) * 0.3).clip(-1, 1).astype(np.float32), 16000)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"test_dataset:\n  noisy_dir: {noisy}\n"
                   f"network:\n  checkpoint: {tmp_path / 'params.npz'}\n"
                   f"  enh_folder: {tmp_path / 'enh'}\n")
    infer.main(["-C", str(cfg), "--device", "cpu", "--quant"])

    model = _model(pnp)
    qm = make_quantized_model(model, calibration.calibration_specs(str(noisy), n_wavs=32))
    paths = [str(noisy / f"noisy_fileid_{i}.wav") for i in (1, 2)]
    want = infer.enhance_wavs(qm, paths, device="cpu", progress=False)
    plain = infer.enhance_wavs(model, paths, device="cpu", progress=False)
    for p in paths:
        out, _ = read_wav(str(tmp_path / "enh" / f"{os.path.basename(p)[:-4]}_enh.wav"))
        np.testing.assert_allclose(out, want[p], atol=1 / 32768)
        assert np.abs(want[p] - plain[p]).max() > 1e-4  # the quantized model ran
    with pytest.raises(SystemExit):
        infer.main(["-C", str(cfg), "--device", "cpu", "--quant", "--integer_pc"])
