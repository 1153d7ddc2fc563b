"""The port's DNSMOS scorer (gtcrn_micro_tpu_torch.eval.dnsmos) held against
the JAX package's (gtcrn_micro_tpu.eval.dnsmos) on the CPU.

- The port's models are its own copies, byte-equal to JAX's (sha256).
- ``mel_filterbank`` and ``audio_melspec`` are numpy copies: bit-identical.
- ``DnsmosScorer``: all four MOS values within 1e-4 of JAX's on a seeded
  clip shorter than 9.01 s (repeat-padded) and one of 12 s (3 hops); the
  port scores a clip's segments as one batch, which equals its loop of
  single-segment calls to 1e-5 on the raw model outputs (measured 6e-7).
- ``main``: the same files, uids and order as JAX's for one split and for
  ``--nsplits 2 --job 2``; RESULTS.txt's 4-decimal text equal and every
  per-utterance score within 1e-4 (the two executors' float32 sums differ in
  the last bits, so the full-precision scp text does not).
- ``evaluate --metric dnsmos`` runs end to end from a YAML config.
"""

import hashlib
import os

import numpy as np
import pytest

import torch

from gtcrn_micro_tpu.eval import dnsmos as jdnsmos
from gtcrn_micro_tpu_torch.eval import dnsmos, evaluate
from gtcrn_micro_tpu_torch.io.wav import write_wav

FS = 16000


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _clip(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * FS)) / FS
    tone = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t)) / 2
    return (tone + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def scorers():
    return dnsmos.DnsmosScorer(device="cpu"), jdnsmos.DnsmosScorer()


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dnsmos")
    lines = []
    for i, secs in enumerate((3.0, 2.0)):
        path = root / f"u{i}.wav"
        write_wav(str(path), _clip(secs, 10 + i), FS)
        lines.append(f"utt{i} {path}\n")
    (root / "inf.scp").write_text("".join(lines))
    return root


@pytest.mark.parametrize("name", ["sig_bak_ovr.onnx", "model_v8.onnx"])
def test_models_are_the_ports_own_byte_equal_copies(name):
    port = os.path.join(dnsmos.DEFAULT_MODEL_DIR, name)
    jax_copy = os.path.join(jdnsmos.DEFAULT_MODEL_DIR, name)
    assert os.path.realpath(port) != os.path.realpath(jax_copy)
    assert "gtcrn_micro_tpu_torch" in os.path.realpath(port)
    digest = [hashlib.sha256(open(p, "rb").read()).hexdigest() for p in (port, jax_copy)]
    assert digest[0] == digest[1]


def test_melspec_bit_identical():
    np.testing.assert_array_equal(dnsmos.mel_filterbank(FS, 321, 120),
                                  jdnsmos.mel_filterbank(FS, 321, 120))
    x = _clip(9.0, 1)
    got, want = dnsmos.audio_melspec(x), jdnsmos.audio_melspec(x)
    assert got.dtype == want.dtype and got.shape == want.shape == (900, 120)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seconds", [5.0, 12.0])
def test_scorer_matches_jax(scorers, seconds):
    port, ref = scorers
    audio = _clip(seconds, int(seconds))
    got, want = port(audio), ref(audio)
    assert list(got) == list(want) == list(dnsmos.METRICS)
    for k in dnsmos.METRICS:
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])
    assert len(dnsmos.segments(audio)) == (1 if seconds < 9.01 else 3)


def test_empty_audio_is_refused():
    """JAX's repeat-padding loops forever on an empty clip; the port raises."""
    with pytest.raises(ValueError, match="at least one sample"):
        dnsmos.segments(np.zeros(0, np.float32))
    # one sample doubles to 2**18 samples (16.4 s): 7 hops, as JAX's loop counts
    assert dnsmos.segments(np.ones(1, np.float32)).shape == (7, 144160)


def test_scorer_batch_equals_segment_loop(scorers):
    port = scorers[0]
    audio = _clip(12.0, 3)
    raw, p808 = port.raw(audio)
    segs = dnsmos.segments(audio)
    loop = np.concatenate([port.primary(s[None])[0] for s in segs])
    loop808 = np.array([port.p808(dnsmos.audio_melspec(s[:-160])[None])[0][0, 0] for s in segs])
    np.testing.assert_allclose(raw, loop, atol=1e-5, rtol=0)
    np.testing.assert_allclose(p808, loop808, atol=1e-5, rtol=0)


def _scores(path):
    return [(uid, float(v)) for uid, v in (ln.split() for ln in open(path))]


@pytest.mark.parametrize("split", [(1, 1), (2, 2)])
def test_main_writes_jax_files(wavs, tmp_path, split):
    nsplits, job = split
    args = ["--inf_scp", str(wavs / "inf.scp"), "--nsplits", str(nsplits), "--job", str(job)]
    dnsmos.main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    jdnsmos.main(args + ["--output_dir", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    suffix = "" if split == (1, 1) else ".2"
    assert names == sorted([f"{m}{suffix}.scp" for m in dnsmos.METRICS]
                           + (["RESULTS.txt"] if split == (1, 1) else []))
    for name in names:
        if name == "RESULTS.txt":
            assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
            continue
        got, want = _scores(tmp_path / "port" / name), _scores(tmp_path / "jax" / name)
        assert [u for u, _ in got] == [u for u, _ in want] == (
            ["utt0", "utt1"] if split == (1, 1) else ["utt1"])
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want], atol=1e-4, rtol=0)


def test_evaluate_dnsmos_end_to_end(wavs, tmp_path):
    enh = tmp_path / "enhanced"
    enh.mkdir()
    (enh / "inf.scp").write_text((wavs / "inf.scp").read_text())
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"network:\n  exp_path: {tmp_path}\n"
                   "  enh_folder: ${network.exp_path}/enhanced  # interpolated\n")
    evaluate.main(["-C", str(cfg), "--metric", "dnsmos", "--device", "cpu"])
    lines = (enh / "RESULTS_dnsmos" / "RESULTS.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines] == list(dnsmos.METRICS)
    assert all(1.0 <= float(ln.split(": ")[1]) <= 5.0 for ln in lines)
