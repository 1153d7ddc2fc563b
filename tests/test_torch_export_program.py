"""The port's portable exports held against the JAX package on the CPU:
``io/export_program.py`` (``torch.export`` programs, the counterpart of
``io/export_stablehlo.py``), its CLI, and the GTCRN-Micro files of
``io/onnx_export.py``.

One run of the port's CLI (``--format all``, 8 frames) on a ``.npz`` of the
JAX init params (``GTCRNMicro().init(PRNGKey(0))``) gives the files most
tests read; the JAX references run eagerly (no jit compile of the model).

- Programs: the offline program matches JAX's ``apply`` (2e-6, the JAX ONNX
  test's bound); the streaming and audio programs (T = 1 and 4, ``mxu`` and
  ``fft``), saved and reloaded, are driven for 20 hops, past the 16-slot
  ring wrap that a baked-in int counter would break, against JAX's
  ``model.step`` / ``make_audio_step`` on ring state at 1e-6; the
  ``fft`` program over a whole utterance reproduces the port's offline
  ``stft -> apply -> istft`` (2e-4, tests/io/test_export_audio.py:90).
- ONNX: the port's offline (8 frames), stream (6 frames, caches threaded)
  and audio (3 chunks) files run on the port's executor and on JAX's
  ``OnnxModel``, against JAX's ``apply``, ``step`` and ``make_audio_step``
  at 2e-6, 2e-6 and 1e-5 (tests/io/test_onnx_export.py,
  tests/io/test_export_audio.py:86).
- CLI: ``--format all`` writes the seven files and each reloads;
  ``--format native`` writes JAX's CLI's bytes from the same params (JAX's
  CLI reads them through a patched ``load_params``: it reads no ``.npz``);
  ``--format native-int8 --calib_dir`` (two seeded 1 s wavs) writes JAX's
  weights bytes and zero points, and activation scales within 1e-6 of
  JAX's (measured 2.4e-7): the ranges are percentiles of activations that
  the two float32 forwards round differently, as tests/test_torch_quant.py
  bounds them (1e-6 of each range); ``--gptq`` keeps those activation
  params and changes weight codes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.dsp import stream_dsp as jdsp
from gtcrn_micro_tpu.dsp.stft import sqrt_hann_window as j_window
from gtcrn_micro_tpu.io import export_stablehlo as jcli
from gtcrn_micro_tpu.io.onnx import OnnxModel as JOnnx
from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu_torch.dsp.stft import istft, sqrt_hann_window, stft
from gtcrn_micro_tpu_torch.io import export_program as xp
from gtcrn_micro_tpu_torch.io.onnx import OnnxModel
from gtcrn_micro_tpu_torch.io.wav import write_wav
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro

FRAMES = 8
HOPS = 20


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX model, JAX params, the port's model, work dir, CLI output dir)."""
    root = tmp_path_factory.mktemp("export")
    jm = JModel()
    jp = jm.init(jax.random.PRNGKey(0))
    pnp = jax.tree.map(np.asarray, jp)
    np.savez(root / "params.npz", **_flat(pnp))
    xp.main(["--checkpoint", str(root / "params.npz"), "--out_dir", str(root / "out"),
             "--frames", str(FRAMES), "--device", "cpu"])
    return jm, jp, GTCRNMicro.from_params(pnp, device="cpu"), root, root / "out"


def _chunks(n, T, seed, batch=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, 256 * T)) * 0.1).astype(np.float32) for _ in range(n)]


def _jax_audio(jm, jp, chunks, dft, ring):
    step = jdsp.make_audio_step(jm, j_window(512), dft=dft)
    batch = chunks[0].shape[0]
    dsp, state = jdsp.init_dsp_state(batch), jm.init_state(batch, ring=ring)
    outs = []
    for c in chunks:
        out, dsp, state = step(jp, dsp, state, jnp.asarray(c))
        outs.append(np.asarray(out))
    return outs


def test_cli_all_writes_every_file_and_each_reloads(setup):
    *_, out = setup
    names = sorted(p.name for p in out.iterdir())
    assert names == sorted([
        "gtcrn_micro_offline.pt2", "gtcrn_micro_stream.pt2", "gtcrn_micro_audio.pt2",
        "gtcrn_micro.onnx", "gtcrn_micro_stream.onnx", "gtcrn_micro_audio.onnx",
        "gtcrn_micro_weights.bin"])
    for name in names:
        if name.endswith(".pt2"):
            assert isinstance(xp.load_exported(str(out / name)), xp.ExportedStep)
        elif name.endswith(".onnx"):
            model = OnnxModel(str(out / name), device="cpu")
            assert model.input_names[-1] in ("audio", "audio_in")


def test_offline_program_matches_jax_apply(setup):
    jm, jp, _, _, out = setup
    prog = xp.load_exported(str(out / "gtcrn_micro_offline.pt2"))
    spec = np.random.default_rng(3).standard_normal((1, 257, FRAMES, 2)).astype(np.float32)
    got = prog(torch.from_numpy(spec)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(jp, jnp.asarray(spec))), atol=2e-6)


def test_streaming_program_past_the_ring_wrap(setup):
    jm, jp, model, _, out = setup
    prog = xp.load_exported(str(out / "gtcrn_micro_stream.pt2"))
    rng = np.random.default_rng(4)
    state, jstate = model.init_state(1), jm.init_state(1)
    for _ in range(HOPS):
        frame = rng.standard_normal((1, 257, 1, 2)).astype(np.float32)
        got, state = prog(state, torch.from_numpy(frame))
        want, jstate = jm.step(jp, jstate, jnp.asarray(frame))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert int(state["step"]) == HOPS % 16


@pytest.fixture(scope="module")
def audio_programs(setup):
    """The audio programs by (T, dft): the CLI's (1, mxu) and three more."""
    _, _, model, _, out = setup
    progs = {(1, "mxu"): xp.load_exported(str(out / "gtcrn_micro_audio.pt2"))}
    for T, dft in ((4, "mxu"), (1, "fft"), (4, "fft")):
        progs[(T, dft)] = xp.load_exported(xp.export_audio(model, 1, T, dft))
    return progs


@pytest.mark.parametrize("T,dft", [(1, "mxu"), (4, "mxu"), (1, "fft"), (4, "fft")])
def test_audio_program_matches_jax_over_20_hops(setup, audio_programs, T, dft):
    jm, jp, model, _, _ = setup
    prog = audio_programs[(T, dft)]
    chunks = _chunks(HOPS, T, seed=10 + T)
    want = _jax_audio(jm, jp, chunks, dft, ring=True)
    in_buf, ola_buf, state = torch.zeros(1, 256), torch.zeros(1, 256), model.init_state(1)
    for c, w in zip(chunks, want):
        out, in_buf, ola_buf, state = prog(in_buf, ola_buf, state, torch.from_numpy(c))
        np.testing.assert_allclose(out.numpy(), w, atol=1e-6)
    assert int(state["step"]) == HOPS * T % 16


def test_audio_program_matches_offline_pipeline(setup, audio_programs):
    """The exported step over a whole utterance reproduces the offline
    stft -> model -> istft pipeline (output one hop behind, the first chunk
    the center-trim region, the first 257 input samples silent)."""
    _, _, model, _, _ = setup
    prog = audio_programs[(1, "fft")]
    n = 256 * 12
    audio = np.random.default_rng(2).standard_normal(n).astype(np.float32) * 0.1
    audio[:257] = 0.0
    x = torch.from_numpy(audio)[None]
    window = sqrt_hann_window(512, device="cpu")
    with torch.no_grad():
        offline = istft(model.apply(stft(x, window)), window, length=n)[0].numpy()
    in_buf, ola_buf, state = torch.zeros(1, 256), torch.zeros(1, 256), model.init_state(1)
    outs = []
    for t in range(12):
        out, in_buf, ola_buf, state = prog(in_buf, ola_buf, state, x[:, 256 * t: 256 * (t + 1)])
        outs.append(out.numpy()[0])
    np.testing.assert_allclose(np.concatenate(outs)[256:], offline[: n - 256], atol=2e-4)


@pytest.mark.parametrize("executor", ["port", "jax"])
def test_onnx_offline_on_both_executors(setup, executor):
    jm, jp, _, _, out = setup
    blob = (out / "gtcrn_micro.onnx").read_bytes()
    om = OnnxModel(blob, device="cpu") if executor == "port" else JOnnx(blob)
    assert om.input_names == ["audio"] and om.output_names == ["enhanced"]
    spec = np.random.default_rng(3).standard_normal((1, 257, FRAMES, 2)).astype(np.float32)
    want = np.asarray(jm.apply(jp, jnp.asarray(spec)))
    np.testing.assert_allclose(om(spec)[0], want, atol=2e-6)


@pytest.mark.parametrize("executor", ["port", "jax"])
def test_onnx_stream_on_both_executors(setup, executor):
    jm, jp, _, _, out = setup
    blob = (out / "gtcrn_micro_stream.onnx").read_bytes()
    om = OnnxModel(blob, device="cpu") if executor == "port" else JOnnx(blob)
    state = jm.init_state(1, ring=False)
    keys = sorted(state)
    assert om.input_names == keys + ["audio"]
    assert om.output_names == ["enhanced"] + [f"{k}.out" for k in keys]
    rng = np.random.default_rng(4)
    caches = [np.asarray(state[k]) for k in keys]
    for _ in range(6):
        frame = rng.standard_normal((1, 257, 1, 2)).astype(np.float32)
        res = om(*caches, frame)
        caches = res[1:]
        want, state = jm.step(jp, state, jnp.asarray(frame))
        np.testing.assert_allclose(res[0], np.asarray(want), atol=2e-6)
    for c, k in zip(caches, keys):  # the graph threads the caches
        np.testing.assert_allclose(c, np.asarray(state[k]), atol=2e-6)


@pytest.mark.parametrize("executor", ["port", "jax"])
def test_onnx_audio_on_both_executors(setup, executor):
    jm, jp, _, _, out = setup
    blob = (out / "gtcrn_micro_audio.onnx").read_bytes()
    om = OnnxModel(blob, device="cpu") if executor == "port" else JOnnx(blob)
    keys = sorted(jm.init_state(1, ring=False))
    assert om.input_names == ["dsp.in_buf", "dsp.ola_buf"] + keys + ["audio_in"]
    assert om.output_names == (["audio_out", "dsp.in_buf.out", "dsp.ola_buf.out"]
                               + [f"{k}.out" for k in keys])
    chunks = _chunks(3, 1, seed=1)
    want = _jax_audio(jm, jp, chunks, "mxu", ring=False)
    state = jm.init_state(1, ring=False)
    flat = [np.zeros((1, 256), np.float32)] * 2 + [np.asarray(state[k]) for k in keys]
    for c, w in zip(chunks, want):
        got = om(*flat, c)
        np.testing.assert_allclose(got[0], w, atol=1e-5, rtol=1e-5)
        flat = list(got[1:])


@pytest.mark.parametrize("fmt", ["native", "native-int8"])
def test_cli_native_bytes_equal_jax_cli(setup, tmp_path, monkeypatch, fmt):
    jm, jp, _, root, _ = setup
    args = ["--checkpoint", str(root / "params.npz"), "--format", fmt]
    if fmt == "native-int8":
        calib = tmp_path / "calib"
        calib.mkdir()
        rng = np.random.default_rng(7)
        for i in range(2):
            write_wav(str(calib / f"noisy{i}.wav"),
                      (rng.standard_normal(16000) * 0.1).astype(np.float32), 16000)
        args += ["--calib_dir", str(calib), "--act_bits", "8"]
    xp.main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    from gtcrn_micro_tpu.eval import infer as jinfer

    monkeypatch.setattr(jinfer, "load_params", lambda path: jp)
    jcli.main(args + ["--out_dir", str(tmp_path / "jax"), "--format", fmt])
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["gtcrn_micro_weights.bin" if fmt == "native" else "gtcrn_micro_w8a8.bin"]
    got, want = ((tmp_path / d / names[0]).read_bytes() for d in ("port", "jax"))
    if fmt == "native":
        assert got == want
        return
    # GTM8 v1: weights, then (act_bits, 59) and a (scale f32, zero i32) per path
    head = len(want) - 8 * 59
    assert len(got) == len(want) and got[:head] == want[:head]
    pair = np.dtype([("scale", "<f4"), ("zero", "<i4")])
    g, w = np.frombuffer(got[head:], pair), np.frombuffer(want[head:], pair)
    np.testing.assert_array_equal(g["zero"], w["zero"])
    np.testing.assert_allclose(g["scale"], w["scale"], rtol=1e-6, atol=0)


def test_cli_gptq_rounds_the_weights_on_the_same_grid(setup, tmp_path):
    """``--gptq``: the same activation params as nearest rounding (the ranges
    come before GPTQ), other weight codes, and JAX's file name."""
    root = setup[3]
    calib = tmp_path / "calib"
    calib.mkdir()
    rng = np.random.default_rng(8)
    for i in range(2):
        write_wav(str(calib / f"noisy{i}.wav"),
                  (rng.standard_normal(16000 * 5) * 0.1).astype(np.float32), 16000)
    args = ["--checkpoint", str(root / "params.npz"), "--format", "native-int8",
            "--calib_dir", str(calib), "--device", "cpu"]
    xp.main(args + ["--out_dir", str(tmp_path / "nearest")])
    xp.main(args + ["--out_dir", str(tmp_path / "gptq"), "--gptq", "--gptq_clips", "2"])
    nearest = (tmp_path / "nearest" / "gtcrn_micro_w8a16.bin").read_bytes()
    gptq = (tmp_path / "gptq" / "gtcrn_micro_w8a16_gptq.bin").read_bytes()
    head = len(nearest) - 8 * 59
    assert len(gptq) == len(nearest) and gptq[head:] == nearest[head:]
    assert gptq[:head] != nearest[:head]
