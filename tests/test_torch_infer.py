"""The port's bulk offline enhancement (gtcrn_micro_tpu_torch.eval.infer)
held against the JAX package's ``eval/infer.py``, on the CPU.

The same wav files and numpy params go through both; the JAX reference runs
eagerly (``jax.disable_jit``).  Tolerance atol 1e-5 on audio of scale 0.3:
the spectra bound of the JAX package's model tests (tests/models/
test_gtcrn_micro.py:67-69), here after the iSTFT; measured 1.8e-7 on outputs
up to 0.54.
"""

import os

import numpy as np
import pytest

import jax

from gtcrn_micro_tpu.eval import infer as jinfer
from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu_torch.eval import infer
from gtcrn_micro_tpu_torch.io.wav import read_wav, write_wav
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro


@pytest.fixture(scope="module")
def setup():
    pnp = jax.tree.map(np.asarray, JModel().init(jax.random.PRNGKey(0)))
    return pnp, GTCRNMicro.from_params(pnp, device="cpu")


def _wavs(tmp_path, specs):
    """Write seeded noise wavs of (name, samples, fs); return their paths."""
    rng = np.random.default_rng(0)
    paths = []
    for name, n, fs in specs:
        p = str(tmp_path / name)
        write_wav(p, (rng.standard_normal(n) * 0.3).clip(-1, 1), fs)
        paths.append(p)
    return paths


def test_enhance_wavs_matches_jax(setup, tmp_path):
    """Three wavs in two frame buckets (64 and 128), one at 8 kHz."""
    pnp, model = setup
    paths = _wavs(tmp_path, [("a.wav", 5000, 16000), ("b.wav", 12000, 16000),
                             ("c.wav", 10000, 8000)])
    got = infer.enhance_wavs(model, paths, batch_size=2, device="cpu", progress=False)
    with jax.disable_jit():
        want = jinfer.enhance_wavs(JModel(), pnp, paths, batch_size=2, progress=False)
    assert [len(got[p]) for p in paths] == [5000, 12000, 20000]
    for p in paths:
        assert got[p].dtype == np.float32
        np.testing.assert_allclose(got[p], want[p], atol=1e-5, err_msg=p)


def test_enhance_silent_and_short_wavs(setup, tmp_path):
    """Silence in -> exactly 0 out; a wav of 200 samples (shorter than the
    reflect pad) works, where the JAX package's tail pad fails."""
    pnp, model = setup
    silent = str(tmp_path / "silent.wav")
    write_wav(silent, np.zeros(9000, np.float32), 16000)
    (short,) = _wavs(tmp_path, [("short.wav", 200, 16000)])
    got = infer.enhance_wavs(model, [silent, short], device="cpu", progress=False)
    assert float(np.abs(got[silent]).max()) == 0.0
    assert got[short].shape == (200,) and np.isfinite(got[short]).all()
    assert float(np.abs(got[short]).max()) > 0.0
    with jax.disable_jit(), pytest.raises(ValueError):
        jinfer.enhance_wavs(JModel(), pnp, [short], progress=False)


def test_main_writes_wavs_and_manifests(setup, tmp_path):
    pnp, model = setup
    noisy, clean, enh = (tmp_path / d for d in ("noisy", "clean", "enh"))
    noisy.mkdir()
    clean.mkdir()
    paths = _wavs(noisy, [("noisy_fileid_1.wav", 6000, 16000),
                          ("noisy_fileid_2.wav", 7000, 16000)])
    _wavs(clean, [("clean_fileid_1.wav", 5800, 16000), ("clean_fileid_2.wav", 7100, 16000)])
    ckpt = str(tmp_path / "params.npz")
    flat = {"/".join(k.key for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(pnp)}
    np.savez(ckpt, **flat)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"test_dataset:\n  noisy_dir: {noisy}\n  clean_dir: {clean}\n"
                   f"network:\n  exp_path: {tmp_path}\n  checkpoint: {ckpt}\n"
                   f"  enh_folder: ${{network.exp_path}}/enh\n"
                   f"network_config:\n  n_fft: 512\n  hop_len: 256\n  win_len: 512\n")
    infer.main(["-C", str(cfg), "--device", "cpu", "--batch-size", "2"])

    want = infer.enhance_wavs(model, paths, device="cpu", progress=False)
    inf = (enh / "inf.scp").read_text().split("\n")
    ref = (enh / "ref.scp").read_text().split("\n")
    assert inf[:2] == [f"noisy_fileid_{i} {enh}/noisy_fileid_{i}_enh.wav" for i in (1, 2)]
    assert ref[:2] == [f"noisy_fileid_{i} {clean}/clean_fileid_{i}.wav" for i in (1, 2)]
    for p, n_clean in zip(paths, (5800, 7100)):
        uid = os.path.basename(p)[:-4]
        out, fs = read_wav(str(enh / f"{uid}_enh.wav"))
        assert fs == 16000 and len(out) == n_clean  # length-matched to clean
        n = min(n_clean, len(want[p]))
        np.testing.assert_allclose(out[:n], want[p][:n], atol=1 / 32768)
        assert not out[n:].any()
