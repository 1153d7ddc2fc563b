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


@pytest.mark.parametrize("fs,n,channels", [(16000, 12345, 1), (8000, 10001, 1),
                                            (11025, 7777, 1), (22050, 9999, 1),
                                            (44100, 30001, 2), (48000, 47999, 1)])
def test_header_length_is_the_read_length(tmp_path, fs, n, channels):
    """``enhance_wavs`` buckets by the length its headers give at 16 kHz
    before it reads a wav: that length is the length of the wav read and
    resampled."""
    from gtcrn_micro_tpu_torch.io.wav import wav_info

    p = str(tmp_path / "x.wav")
    x = np.random.default_rng(n).standard_normal((n, channels)) * 0.3
    write_wav(p, x.clip(-1, 1), fs)
    info = wav_info(p)
    assert (info.frames, info.fs, info.channels, info.pcm16) == (n, fs, channels, True)
    assert infer._length_16k(info.frames, info.fs) == len(infer._read_16k(p))


def test_raw_and_float_batches_agree(setup, tmp_path):
    """A mono 16-bit wav at 16 kHz goes to the model as its raw samples,
    read straight into the batch and scaled on the device; the same samples
    as the first channel of a stereo wav go as float32 from ``read_wav``.
    Both give the same output, bit for bit."""
    from gtcrn_micro_tpu_torch.io.wav import read_pcm16_into, wav_info

    _, model = setup
    x = (np.random.default_rng(5).standard_normal((9000, 2)) * 0.3).clip(-1, 1)
    mono, stereo = str(tmp_path / "mono.wav"), str(tmp_path / "stereo.wav")
    write_wav(mono, x[:, 0], 16000)
    write_wav(stereo, x, 16000)
    raw = np.empty(9000, np.int16)
    read_pcm16_into(mono, wav_info(mono), raw)
    np.testing.assert_array_equal(raw, read_wav(mono, dtype=np.int16)[0])
    with pytest.raises(ValueError):
        read_pcm16_into(stereo, wav_info(stereo), np.empty(9000, np.int16))
    got = infer.enhance_wavs(model, [mono], device="cpu", progress=False)[mono]
    want = infer.enhance_wavs(model, [stereo], device="cpu", progress=False)[stereo]
    assert got.shape == (9000,) and np.array_equal(got, want)


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
