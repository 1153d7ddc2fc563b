"""The port's DSP (gtcrn_micro_tpu_torch.dsp) held against the JAX package.

Same numpy inputs through both; JAX runs on the CPU.  Tolerances, each no
looser than the JAX package's own tests for the same quantity:

- ERB filters, windows and the DFT matrices are built by the same float32 /
  float64 numpy code: exact (windows within 1e-7).
- spectra: the FFT libraries and the depth-512 GEMMs sum in other orders
  than JAX's.  Measured gaps 7.6e-6 (FFT) and 1.05e-5 (GEMM) on spectra up
  to 53 in magnitude, i.e. ~2e-7 relative; bound atol 1e-5 plus rtol 1e-6
  (tests/dsp/test_stream_dsp.py:167 allows 2e-4, tests/dsp/test_stft.py
  2e-4 plus rtol 1e-5).
- audio of unit scale: measured 7.2e-7 (FFT) and 1.7e-6 (GEMM); bound 2e-6
  (test_stream_dsp.py:176 allows 2e-5).
- bf16 synthesis: every sample within one bf16 step (rtol 2^-7) plus the
  audio bound 2e-6 of JAX's (test_stream_dsp.py:180 only bounds the bf16
  round trip's SNR).
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

# the JAX dsp package re-exports functions under its module names
jerb = importlib.import_module("gtcrn_micro_tpu.dsp.erb")
jstft = importlib.import_module("gtcrn_micro_tpu.dsp.stft")
jsd = importlib.import_module("gtcrn_micro_tpu.dsp.stream_dsp")
from gtcrn_micro_tpu_torch.dsp import erb as terb
from gtcrn_micro_tpu_torch.dsp import stft as tstft
from gtcrn_micro_tpu_torch.dsp import stream_dsp as tsd

HOP = 256
SPEC_TOL = dict(atol=1e-5, rtol=1e-6)
AUDIO_TOL = 2e-6
BF16_AUDIO_TOL = dict(rtol=2.0**-7, atol=AUDIO_TOL)  # one bf16 step


def _signal(batch=2, hops=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, HOP * hops)).astype(np.float32)


@pytest.fixture(scope="module")
def windows():
    return jstft.sqrt_hann_window(512), tstft.sqrt_hann_window(512, device="cpu")


def test_erb_filters_exact():
    np.testing.assert_array_equal(terb.erb_filter_banks(65, 64),
                                  jerb.erb_filter_banks(65, 64))
    jp = jerb.ErbBands().init_params()
    tp = terb.ErbBands().init_params(device="cpu")
    for k in ("bm_w", "bs_w"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    x = np.random.default_rng(1).standard_normal((2, 3, 257)).astype(np.float32)
    bm = terb.ErbBands().bm(tp, torch.from_numpy(x))
    np.testing.assert_array_equal(bm[..., :65].numpy(), x[..., :65])
    np.testing.assert_allclose(bm.numpy(), np.asarray(jerb.ErbBands().bm(jp, jnp.asarray(x))),
                               atol=1e-6)


@pytest.mark.parametrize("name", ["hann_window", "sqrt_hann_window"])
def test_windows_match(name):
    j = np.asarray(getattr(jstft, name)(512))
    t = getattr(tstft, name)(512, device="cpu").numpy()
    assert t.dtype == np.float32
    assert np.abs(t - j).max() <= 1e-7


def test_offline_stft_istft_match(windows):
    jw, tw = windows
    x = _signal(hops=20, seed=2)
    js = np.asarray(jstft.stft(jnp.asarray(x), jw))
    ts = tstft.stft(torch.from_numpy(x), tw).numpy()
    assert ts.shape == js.shape
    np.testing.assert_allclose(ts, js, **SPEC_TOL)
    jy = np.asarray(jstft.istft(jnp.asarray(js), jw, length=x.shape[1]))
    ty = tstft.istft(torch.from_numpy(js.copy()), tw, length=x.shape[1]).numpy()
    np.testing.assert_allclose(ty, jy, atol=AUDIO_TOL)


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("bucket", [128, 256, 1024])
@pytest.mark.parametrize("short", [0, 1000])
def test_istft_ola_matches_istft(windows, rows, bucket, short):
    """The iSTFT without a read back (an envelope built once per shape), and
    ``istft`` over it, against ``torch.istft`` at float32 round-off, on
    ``enhance_wavs``'s bucket shapes (T = bucket + 1 frames), to ``length``
    hop (T - 1) and shorter."""
    tw = windows[1]
    T, length = bucket + 1, HOP * bucket - short
    spec = torch.randn((rows, 257, T, 2), generator=torch.Generator().manual_seed(bucket + rows))
    env = tstft.ola_envelope(tw, T, length)
    got = tstft.istft_ola(spec, tw, length, env)
    want = torch.istft(torch.view_as_complex(spec), 512, HOP, 512, tw, center=True,
                       normalized=False, onesided=True, length=length)
    assert got.shape == want.shape == (rows, length)
    assert float((got - want).norm() / want.norm()) <= 1e-6
    torch.testing.assert_close(tstft.istft(spec, tw, length=length), got, rtol=0, atol=0)


def test_istft_ola_zero_envelope_raises_as_istft():
    zero = torch.zeros(512)
    spec = torch.randn((2, 257, 9, 2))
    with pytest.raises(RuntimeError, match="window overlap add min"):
        torch.istft(torch.view_as_complex(spec), 512, HOP, 512, zero, length=HOP * 8)
    with pytest.raises(RuntimeError, match="window overlap add min"):
        tstft.ola_envelope(zero, 9, HOP * 8)
    with pytest.raises(RuntimeError, match="window overlap add min"):
        tstft.istft(spec, zero, length=HOP * 8)


def test_dft_mats_exact(windows):
    jw, tw = windows
    for j, t in zip(jsd._dft_mats(jw), tsd._dft_mats(tw)):
        np.testing.assert_array_equal(t, j)


def _stream(analyse, synth, x, T, make_state):
    """Run analysis then synthesis chunk by chunk; return (spectra, audio)."""
    sa, ss = make_state(), make_state()
    specs, outs = [], []
    for t in range(0, x.shape[1] // HOP, T):
        chunk = x[:, HOP * t : HOP * (t + T)]
        f, sa = analyse(sa, chunk)
        specs.append(np.asarray(f))
        o, ss = synth(ss, f)
        outs.append(np.asarray(o))
    return np.concatenate(specs, axis=2), np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("form", ["fft", "gemm"])
def test_stream_chunks_match(windows, T, form):
    jw, tw = windows
    x = _signal(hops=16, seed=3)
    B = x.shape[0]
    if form == "fft":
        j_an = lambda s, c: jsd.stft_chunk(s, jnp.asarray(c), jw)
        j_sy = lambda s, f: jsd.istft_chunk(s, f, jw)
        t_an = lambda s, c: tsd.stft_chunk(s, torch.from_numpy(c), tw)
        t_sy = lambda s, f: tsd.istft_chunk(s, f, tw)
    else:
        jf, ji = jsd._dft_mats(jw)
        tf_, ti = (torch.from_numpy(m) for m in tsd._dft_mats(tw))
        j_an = lambda s, c: jsd._stft_chunk_mxu(s, jnp.asarray(c), jf)
        j_sy = lambda s, f: jsd._istft_chunk_mxu(s, f, ji)
        t_an = lambda s, c: tsd._stft_chunk_mxu(s, torch.from_numpy(c), tf_)
        t_sy = lambda s, f: tsd._istft_chunk_mxu(s, f, ti)
    js, jy = _stream(j_an, j_sy, x, T, lambda: jsd.init_dsp_state(B))
    ts, ty = _stream(t_an, t_sy, x, T, lambda: tsd.init_dsp_state(B, device="cpu"))
    assert ts.shape == js.shape == (B, 257, 16, 2) and ty.shape == jy.shape == x.shape
    np.testing.assert_allclose(ts, js, **SPEC_TOL)
    np.testing.assert_allclose(ty, jy, atol=AUDIO_TOL)
    # the online contract: output one hop behind, the first hop is the
    # center trim, and analysis -> synthesis reconstructs the input
    np.testing.assert_allclose(ty[:, HOP:], x[:, :-HOP], atol=1e-5)


@pytest.mark.parametrize("T", [1, 4])
def test_istft_chunk_mxu_bf16_rounds_once(windows, T):
    """bf16 synthesis: the GEMM's frames stay float32 through the
    overlap-add and are rounded to bf16 once, as in the JAX package.  Both
    sides then round float32 values that agree to ~2e-7 (measured 1.8e-7 on
    frames of unit scale), so every output sample is within one bf16 step of
    JAX's plus the float32 audio bound (a second rounding of the frames
    before the add is off by more where heads and tails cancel)."""
    jw, tw = windows
    _, ji = jsd._dft_mats(jw)
    ti = torch.from_numpy(tsd._dft_mats(tw)[1]).to(torch.bfloat16).float()
    B, hops = 4, 8
    rng = np.random.default_rng(5)
    spec = (rng.standard_normal((B, 257, hops, 2)) * 4.0).astype(np.float32)
    js, ts = jsd.init_dsp_state(B, jnp.bfloat16), tsd.init_dsp_state(B, torch.bfloat16, "cpu")
    jo, to = [], []
    for t in range(0, hops, T):
        s = torch.from_numpy(spec[:, :, t : t + T]).to(torch.bfloat16)
        o, ts = tsd._istft_chunk_mxu(ts, s, ti)
        to.append(o.float().numpy())
        o, js = jsd._istft_chunk_mxu(js, jnp.asarray(s.float().numpy(), jnp.bfloat16), ji)
        jo.append(np.asarray(o, np.float32))
    assert to[0].shape == (B, 256 * T) and o.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.concatenate(to, -1), np.concatenate(jo, -1),
                               **BF16_AUDIO_TOL)


class _Gain:
    """A stand-in model with the port's step protocol: halves the spectrum."""

    def step(self, state, spec):
        return spec * 0.5, state


class _JGain:
    """The same stand-in with the JAX package's step protocol."""

    def step(self, params, state, spec):
        return spec * 0.5, state


@pytest.mark.parametrize("dft", ["fft", "mxu"])
def test_audio_step_and_scan_match(windows, dft):
    jw, tw = windows
    x = _signal(batch=3, hops=10, seed=4)
    jstep = jsd.make_audio_step(_JGain(), jw, dft=dft)
    tstep = tsd.make_audio_step(_Gain(), tw, dft=dft)
    jd, td = jsd.init_dsp_state(3), tsd.init_dsp_state(3, device="cpu")
    jo, to = [], []
    for t in range(10):
        c = x[:, HOP * t : HOP * (t + 1)]
        o, jd, _ = jstep(None, jd, None, jnp.asarray(c))
        jo.append(np.asarray(o))
        o, td, _ = tstep(td, None, torch.from_numpy(c))
        to.append(o.numpy())
    jo, to = np.concatenate(jo, -1), np.concatenate(to, -1)
    np.testing.assert_allclose(to, jo, atol=AUDIO_TOL)
    scan = tsd.make_audio_scan(_Gain(), tw, dft=dft)
    so, _, _ = scan(tsd.init_dsp_state(3, device="cpu"), None, torch.from_numpy(x))
    np.testing.assert_array_equal(so.numpy(), to)


@pytest.mark.parametrize("dft", ["fft", "mxu"])
def test_audio_step_and_scan_carry_t_hop_chunks(windows, dft):
    """Chunks of T = 4 hops, (B, 1024) samples, through the audio step (as
    the JAX step takes them), and the same audio one hop at a time through
    the scan."""
    jw, tw = windows
    T, hops = 4, 12
    x = _signal(batch=3, hops=hops, seed=7)
    jstep = jsd.make_audio_step(_JGain(), jw, dft=dft)
    tstep = tsd.make_audio_step(_Gain(), tw, dft=dft)
    jd, td = jsd.init_dsp_state(3), tsd.init_dsp_state(3, device="cpu")
    jo, to = [], []
    for t in range(0, hops, T):
        c = x[:, HOP * t : HOP * (t + T)]
        o, jd, _ = jstep(None, jd, None, jnp.asarray(c))
        jo.append(np.asarray(o))
        o, td, _ = tstep(td, None, torch.from_numpy(c))
        assert o.shape == (3, HOP * T)
        to.append(o.numpy())
    to = np.concatenate(to, -1)
    np.testing.assert_allclose(to, np.concatenate(jo, -1), atol=AUDIO_TOL)
    scan = tsd.make_audio_scan(_Gain(), tw, dft=dft)
    so, _, _ = scan(tsd.init_dsp_state(3, device="cpu"), None, torch.from_numpy(x))
    np.testing.assert_allclose(so.numpy(), to, atol=AUDIO_TOL)


def test_make_audio_step_rejects_unknown_dft(windows):
    with pytest.raises(ValueError):
        tsd.make_audio_step(_Gain(), windows[1], dft="fht")
