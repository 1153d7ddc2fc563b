"""The port's ONNX emitter (gtcrn_micro_tpu_torch.io.onnx_export) on small
torch functions, and JAX-emitted GTCRN-Micro files on the port's executor.

- Lowering (the counterpart of tests/io/test_onnx_export.py:41-90, on torch
  functions): each function is exported, run through the port's executor
  and JAX's ``OnnxModel``, and compared with the function itself at atol
  1e-6, rtol 1e-5 (:38).  A function that updates an input in place gets
  the ``<name>.out`` output, and a transposed conv (refused: no
  ConvTranspose in the executors' op set) raises.
- JAX-emitted files: JAX's offline (8 frames), stream (6 frames) and audio
  (3 chunks) files on the port's executor against JAX's ``apply``, ``step``
  and ``make_audio_step``, at the bounds of JAX's own round trips (2e-6,
  2e-6, 1e-5).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as tF

from gtcrn_micro_tpu.dsp import stream_dsp as jdsp
from gtcrn_micro_tpu.dsp.stft import sqrt_hann_window as j_window
from gtcrn_micro_tpu.io import onnx_export as jexport
from gtcrn_micro_tpu.io.onnx import OnnxModel as JOnnx
from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu_torch.io.onnx import OnnxModel, load_onnx
from gtcrn_micro_tpu_torch.io.onnx_export import export_onnx


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _t(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _roundtrip(fn, *args):
    blob = export_onnx(fn, args)
    want = fn(*args)
    want = [want] if torch.is_tensor(want) else list(want)
    feeds = [a.numpy() for a in args]
    for om in (OnnxModel(blob, device="cpu"), JOnnx(blob)):
        got = om(*feeds)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), w.numpy(), atol=1e-6, rtol=1e-5)
    return blob


_X = _t(2, 3, 5)
_W = _t(5, 4, seed=1)

LOWERINGS = {
    "matmul": (lambda a: a @ _W, (_X,)),
    "tanh_sigmoid": (lambda a: torch.tanh(a) + torch.sigmoid(a) * a, (_X,)),
    "rsqrt": (lambda a: torch.rsqrt(torch.abs(a) + 1.0), (_X,)),
    "permute_reshape": (lambda a: a.permute(2, 0, 1).reshape(5, 6), (_X,)),
    "cat_slice": (lambda a: torch.cat([a, a * 2.0], dim=1)[:, 1:4], (_X,)),
    "mean": (lambda a: (a * a).mean(dim=2), (_X,)),
    "relu_min": (lambda a: torch.relu(a) + 0.25 * torch.minimum(a, torch.zeros_like(a)), (_X,)),
    "expand": (lambda a: a[:, :1, :].expand(2, 3, 5), (_X,)),
    "where": (lambda a: torch.where(a > 0, a, 2.0 * a), (_X,)),
    "pad": (lambda a: tF.pad(a, (0, 0, 1, 2)), (_X,)),
    "select_unsqueeze": (lambda a: a[:, 1].unsqueeze(0) - a[1:, 2][None], (_X,)),
    "sum_sqrt_div": (lambda a: a.sum(dim=1, keepdim=True) / torch.sqrt(a * a + 1.0), (_X,)),
    "bmm": (lambda a, b: torch.einsum("bik,bkj->bij", a, b),
            (_t(4, 3, 5, seed=2), _t(4, 5, 2, seed=3))),
    "bmm_transposed": (lambda a: torch.einsum("bki,bkj->bij", a, a), (_t(4, 3, 5, seed=2),)),
    "linear": (lambda a: tF.linear(a, _W.t(), _t(4, seed=4)), (_X,)),
}


@pytest.mark.parametrize("name", sorted(LOWERINGS))
def test_lowerings(name):
    fn, args = LOWERINGS[name]
    _roundtrip(fn, *args)


_XC = _t(2, 3, 7, 9, seed=5)  # NCHW
_WC = _t(5, 3, 2, 3, seed=6)

CONVS = {
    "padded": lambda a: tF.conv2d(a, _WC, padding=(1, 1)),
    "strided_bias": lambda a: tF.conv2d(a, _WC, _t(5, seed=7), stride=(1, 2), padding=(0, 2)),
    "dilated": lambda a: tF.conv2d(a, _WC, dilation=(2, 1), padding=(2, 1)),
    "depthwise": lambda a: tF.conv2d(a, _t(3, 1, 3, 3, seed=8), groups=3, padding=1),
    "causal_pad": lambda a: tF.conv2d(tF.pad(a, (1, 1, 1, 0)), _WC),
    "conv1d": lambda a: tF.conv1d(a[:, :, 0], _t(4, 3, 3, seed=9), stride=2),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_lowerings(name):
    _roundtrip(CONVS[name], _XC)


def _zero_stuffed_conv(a):
    """The layered model's transposed frequency conv: zeros stuffed between
    frequency samples (``slice_scatter`` with step 2), then a plain conv."""
    B, C, T, F = a.shape
    up = a.new_zeros((B, C, T, 2 * F - 1))
    up[..., ::2] = a
    return tF.conv2d(up, _WC, padding=(0, 2))


def test_zero_stuffing_lowers_without_scatter():
    blob = _roundtrip(_zero_stuffed_conv, _XC)
    ops = {n.op_type for n in load_onnx(blob).nodes}
    assert "ScatterND" not in ops and "ConvTranspose" not in ops


def test_slice_scatter_into_a_tensor():
    def fn(a, b):
        out = a.clone()
        out[:, 1:5:2] = b * 3.0
        return out
    _roundtrip(fn, _t(2, 6, seed=10), _t(2, 2, seed=11))


def test_in_place_update_becomes_an_output():
    def fn(cache, x):
        y = torch.cat([cache, x], dim=1)
        cache.copy_(y[:, -2:])
        return y.sum(dim=1)

    cache, x = _t(2, 2, 3, seed=12), _t(2, 1, 3, seed=13)
    blob = export_onnx(fn, (cache.clone(), x), input_names=["cache", "x"])
    om = OnnxModel(blob, device="cpu")
    assert om.input_names == ["cache", "x"] and om.output_names == ["output_0", "cache.out"]
    want_cache = cache.clone()
    want = fn(want_cache, x)
    for ex in (om, JOnnx(blob)):
        got = ex(cache.numpy(), x.numpy())
        np.testing.assert_allclose(got[0], want.numpy(), atol=1e-6)
        np.testing.assert_array_equal(got[1], want_cache.numpy())


def test_transposed_conv_is_refused():
    with pytest.raises(NotImplementedError, match="transposed"):
        export_onnx(lambda a: tF.conv_transpose2d(a, _t(3, 2, 3, 3, seed=14)), (_XC,))


# ---------------------------------------------------------------------------
# JAX-emitted files on the port's executor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_model():
    jm = JModel()
    return jm, jm.init(jax.random.PRNGKey(0))


def test_jax_offline_file_on_the_port(jax_model):
    jm, jp = jax_model
    om = OnnxModel(jexport.export_model_onnx(jm, jp, batch=1, frames=8), device="cpu")
    spec = np.random.default_rng(3).standard_normal((1, 257, 8, 2)).astype(np.float32)
    np.testing.assert_allclose(om(spec)[0], np.asarray(jm.apply(jp, jnp.asarray(spec))), atol=2e-6)


def test_jax_stream_file_on_the_port(jax_model):
    jm, jp = jax_model
    om = OnnxModel(jexport.export_stream_onnx(jm, jp, batch=1), device="cpu")
    state = jm.init_state(1, ring=False)
    keys = sorted(state)
    caches = [np.asarray(state[k]) for k in keys]
    rng = np.random.default_rng(4)
    for _ in range(6):
        frame = rng.standard_normal((1, 257, 1, 2)).astype(np.float32)
        res = om(*caches, frame)
        caches = res[1:]
        want, state = jm.step(jp, state, jnp.asarray(frame))
        np.testing.assert_allclose(res[0], np.asarray(want), atol=2e-6)
    for c, k in zip(caches, keys):
        np.testing.assert_allclose(c, np.asarray(state[k]), atol=2e-6)


def test_jax_audio_file_on_the_port(jax_model):
    jm, jp = jax_model
    om = OnnxModel(jexport.export_audio_onnx(jm, jp, batch=1), device="cpu")
    step = jdsp.make_audio_step(jm, j_window(512), dft="mxu")
    dsp, state = jdsp.init_dsp_state(1), jm.init_state(1, ring=False)
    keys = sorted(state)
    flat = [np.zeros((1, 256), np.float32)] * 2 + [np.asarray(state[k]) for k in keys]
    rng = np.random.default_rng(1)
    for _ in range(3):
        c = (rng.standard_normal((1, 256)) * 0.1).astype(np.float32)
        got = om(*flat, c)
        want, dsp, state = step(jp, dsp, state, jnp.asarray(c))
        np.testing.assert_allclose(got[0], np.asarray(want), atol=1e-5, rtol=1e-5)
        flat = list(got[1:])
