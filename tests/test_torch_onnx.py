"""The port's ONNX reader and executor (gtcrn_micro_tpu_torch.io.onnx) held
against the JAX package's (gtcrn_micro_tpu.io.onnx) on the CPU.

- Reader: ``load_onnx`` gives JAX's graph (nodes, attributes, inputs and
  outputs, initializers bit for bit) on both DNSMOS files and on a
  JAX-emitted GTCRN-Micro file.
- Executor: one-node graphs written with the port's protobuf encoder run
  through both executors on seeded inputs, at the JAX emitter tests' bound
  (atol 1e-6, rtol 1e-5; tests/io/test_onnx_export.py:38).  Integer results
  and refusals must agree exactly.
- DNSMOS models: both files, port vs JAX executor, on the inputs of
  tests/eval/test_metrics.py:62-76 and on seeded ones, at rtol 1e-4 /
  atol 1e-5 (measured: 2.4e-7 at most on outputs of 1-3).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.io import onnx as jonnx
from gtcrn_micro_tpu.io.onnx_export import export_model_onnx as j_export_model_onnx
from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu_torch.io import onnx as tonnx
from gtcrn_micro_tpu_torch.io.onnx_export import (
    _f_bytes,
    _model_proto,
    _node_proto,
    _tensor_proto,
    _value_info,
)

JAX_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "gtcrn_micro_tpu", "assets", "dnsmos")
MODELS = ("sig_bak_ovr", "model_v8")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jax_gtcrn_onnx():
    """A JAX-emitted offline GTCRN-Micro file (4 frames)."""
    model = JModel()
    return j_export_model_onnx(model, model.init(jax.random.PRNGKey(0)), batch=1, frames=4)


def _same_value(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", MODELS + ("jax_gtcrn",))
def test_load_onnx_equals_jax(name, jax_gtcrn_onnx):
    src = jax_gtcrn_onnx if name == "jax_gtcrn" else os.path.join(JAX_DIR, f"{name}.onnx")
    t, j = tonnx.load_onnx(src), jonnx.load_onnx(src)
    assert t.inputs == j.inputs and t.outputs == j.outputs
    assert len(t.nodes) == len(j.nodes) > 10
    for tn, jn in zip(t.nodes, j.nodes):
        assert (tn.op_type, tn.inputs, tn.outputs) == (jn.op_type, jn.inputs, jn.outputs)
        assert list(tn.attrs) == list(jn.attrs)
        assert all(_same_value(tn.attrs[k], jn.attrs[k]) for k in tn.attrs), tn.attrs
    assert list(t.initializers) == list(j.initializers)
    assert all(_same_value(t.initializers[k], j.initializers[k]) for k in t.initializers)


# ---------------------------------------------------------------------------
# op by op
# ---------------------------------------------------------------------------


def _graph(op, inputs, attrs, n_out=1):
    """A one-node model: ``inputs`` is a list of (name, array, is_initializer)
    (a None array is an omitted optional input)."""
    names = [n if a is not None else "" for n, a, _ in inputs]
    outs = [f"y{i}" for i in range(n_out)]
    graph = _f_bytes(1, _node_proto(op, names, outs, attrs)) + _f_bytes(2, b"g")
    graph += b"".join(_f_bytes(5, _tensor_proto(n, a)) for n, a, init in inputs
                      if init and a is not None)
    graph += b"".join(_f_bytes(11, _value_info(n, a.shape, a.dtype)) for n, a, init in inputs
                      if not init and a is not None)
    graph += b"".join(_f_bytes(12, _value_info(o, (), np.float32)) for o in outs)
    return _model_proto(graph)


def _r(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _i64(*v):
    return np.asarray(v, np.int64)


_W2 = _r(6, 3, 3, 3, seed=1)   # (O, I, kH, kW)
_W1 = _r(5, 4, 6, seed=2)      # (O, I, k): a framed-DFT-like 1-D conv
_X2 = _r(2, 3, 9, 10, seed=3)
_X1 = _r(2, 4, 23, seed=4)

CASES = {
    "conv2d_pads": ("Conv", [("x", _X2, 0), ("w", _W2, 1), ("b", _r(6, seed=5), 1)],
                    {"pads": [1, 0, 2, 1], "strides": [1, 2], "dilations": [2, 1]}),
    "conv2d_same_upper": ("Conv", [("x", _X2, 0), ("w", _W2, 1)],
                          {"auto_pad": b"SAME_UPPER", "strides": [2, 2]}),
    "conv2d_same_lower": ("Conv", [("x", _X2, 0), ("w", _W2, 1)],
                          {"auto_pad": b"SAME_LOWER", "strides": [2, 1], "dilations": [1, 2]}),
    "conv2d_valid_groups": ("Conv", [("x", _X2, 0), ("w", _r(6, 1, 3, 3, seed=6), 1)],
                            {"auto_pad": b"VALID", "group": 3}),
    "conv2d_pads_1": ("Conv", [("x", _X2, 0), ("w", _W2, 1), ("b", _r(6, seed=7), 1)],
                      {"auto_pad": b"NOTSET", "pads": [1, 1, 1, 1], "kernel_shape": [3, 3]}),
    "conv1d_valid_stride": ("Conv", [("x", _X1, 0), ("w", _W1, 1)],
                            {"auto_pad": b"VALID", "strides": [3], "kernel_shape": [6]}),
    "conv1d_same_upper": ("Conv", [("x", _X1, 0), ("w", _W1, 1), ("b", _r(5, seed=8), 1)],
                          {"auto_pad": b"SAME_UPPER", "dilations": [2]}),
    "conv1d_same_lower_stride": ("Conv", [("x", _X1, 0), ("w", _W1, 1)],
                                 {"auto_pad": b"SAME_LOWER", "strides": [2]}),
    "maxpool": ("MaxPool", [("x", _X2, 0)], {"kernel_shape": [2, 2], "strides": [2, 2]}),
    "maxpool_pads": ("MaxPool", [("x", _X2 - 3.0, 0)],
                     {"kernel_shape": [3, 2], "strides": [2, 1], "pads": [1, 0, 0, 1]}),
    "maxpool_1d": ("MaxPool", [("x", _X1, 0)], {"kernel_shape": [3], "strides": [2]}),
    "avgpool": ("AveragePool", [("x", _X2, 0)], {"kernel_shape": [2, 3], "strides": [2, 2]}),
    "avgpool_pads": ("AveragePool", [("x", _X2, 0)],
                     {"kernel_shape": [3, 3], "pads": [1, 1, 0, 1], "count_include_pad": 1}),
    "avgpool_1d": ("AveragePool", [("x", _X1, 0)], {"kernel_shape": [4], "strides": [3]}),
    "slice_opset1": ("Slice", [("x", _X2, 0)],
                     {"starts": [1, -4], "ends": [3, 100], "axes": [1, 3]}),
    "slice_opset10": ("Slice", [("x", _X2, 0), ("s", _i64(0, 2), 1),
                                ("e", _i64(2**63 - 1, 9), 1), ("a", _i64(0, 2), 1),
                                ("p", _i64(1, 3), 1)], {}),
    "slice_negative_step": ("Slice", [("x", _X2, 0), ("s", _i64(-1), 1), ("e", _i64(-8), 1),
                                      ("a", _i64(3), 1), ("p", _i64(-2), 1)], {}),
    "slice_no_axes": ("Slice", [("x", _X1, 0), ("s", _i64(1, 0), 1), ("e", _i64(2, 3), 1)], {}),
    "pad": ("Pad", [("x", _X2, 0), ("p", _i64(0, 1, 2, 0, 0, 0, 1, 3), 1),
                    ("v", np.asarray(0.5, np.float32), 1)], {}),
    "pad_axes": ("Pad", [("x", _X2, 0), ("p", _i64(2, 1, 0, 3), 1), ("v", None, 1),
                         ("a", _i64(1, 3), 1)], {}),
    "gemm": ("Gemm", [("a", _r(4, 5, seed=9), 0), ("b", _r(6, 4, seed=10), 1),
                      ("c", _r(6, seed=11), 1)],
             {"transA": 1, "transB": 1, "alpha": 0.5, "beta": 2.0}),
    "gemm_plain": ("Gemm", [("a", _r(3, 5, seed=12), 0), ("b", _r(5, 2, seed=13), 1)], {}),
    "matmul": ("MatMul", [("a", _r(2, 3, 5, seed=14), 0), ("b", _r(5, 4, seed=15), 1)], {}),
    "reduce_max": ("ReduceMax", [("x", _X2, 0)], {"axes": [1, 3], "keepdims": 0}),
    "reduce_sum": ("ReduceSum", [("x", _X2, 0), ("a", _i64(2), 1)], {"keepdims": 1}),
    "reduce_mean": ("ReduceMean", [("x", _X2, 0)], {}),
    "reduce_mean_axes": ("ReduceMean", [("x", _X2, 0)], {"axes": [-1], "keepdims": 0}),
    "squeeze_attr": ("Squeeze", [("x", _r(2, 1, 3, 1, seed=16), 0)], {"axes": [1]}),
    "squeeze_input": ("Squeeze", [("x", _r(2, 1, 3, 1, seed=16), 0), ("a", _i64(3, 1), 1)], {}),
    "squeeze_all": ("Squeeze", [("x", _r(2, 1, 3, 1, seed=16), 0)], {}),
    "unsqueeze_attr": ("Unsqueeze", [("x", _X1, 0)], {"axes": [3, 0]}),
    "unsqueeze_input": ("Unsqueeze", [("x", _X1, 0), ("a", _i64(1), 1)], {}),
    "expand": ("Expand", [("x", _r(3, 1, seed=17), 0), ("s", _i64(2, 3, 4), 1)], {}),
    "where": ("Where", [("c", _r(3, 4, seed=18) > 0, 0), ("a", _r(3, 4, seed=19), 0),
                        ("b", _r(1, 4, seed=20), 1)], {}),
    "cast_int": ("Cast", [("x", _X1 * 10, 0)], {"to": 6}),
    "cast_float": ("Cast", [("x", np.arange(-5, 7, dtype=np.int32).reshape(3, 4), 0)], {"to": 1}),
    "clip": ("Clip", [("x", _X2, 0), ("lo", np.asarray(-0.5, np.float32), 1),
                      ("hi", np.asarray(0.75, np.float32), 1)], {}),
    "clip_min_only": ("Clip", [("x", _X2, 0), ("lo", np.asarray(-0.25, np.float32), 1)], {}),
    "reshape": ("Reshape", [("x", _X2, 0), ("s", _i64(2, -1, 10), 1)], {}),
    "transpose": ("Transpose", [("x", _X2, 0)], {"perm": [0, 2, 3, 1]}),
    "flatten": ("Flatten", [("x", _X2, 0)], {"axis": 2}),
    "concat": ("Concat", [("a", _X1, 0), ("b", _r(2, 4, 5, seed=21), 1)], {"axis": -1}),
    "global_avgpool": ("GlobalAveragePool", [("x", _X2, 0)], {}),
    "prelu": ("PRelu", [("x", _X2, 0), ("s", np.asarray(0.25, np.float32), 1)], {}),
    "pow": ("Pow", [("x", np.abs(_X2) + 0.1, 0), ("y", np.asarray(2.5, np.float32), 1)], {}),
    "div_scalar": ("Div", [("x", _X2, 0), ("y", np.asarray(2.3025851, np.float32), 1)], {}),
    "max3": ("Max", [("a", _X1, 0), ("b", _X1[::-1].copy(), 1),
                     ("c", _r(2, 4, 23, seed=22), 1)], {}),
    "reciprocal": ("Reciprocal", [("x", np.abs(_X1) + 0.5, 0)], {}),
    "greater": ("Greater", [("a", _X1, 0), ("b", np.asarray(0.0, np.float32), 1)], {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_executor_ops_match_jax(case):
    op, inputs, attrs = CASES[case]
    blob = _graph(op, inputs, attrs)
    feeds = [a for _, a, init in inputs if not init and a is not None]
    got = tonnx.OnnxModel(blob, device="cpu")(*feeds)
    want = jonnx.OnnxModel(blob)(*feeds)
    assert len(got) == len(want) == 1
    g, w = got[0], np.asarray(want[0])
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
    if g.dtype.kind == "f":
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5)
    else:
        np.testing.assert_array_equal(g, w)


def test_executor_refuses_what_jax_refuses():
    blob = _graph("AveragePool", [("x", _X2, 0)], {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1]})
    for model in (tonnx.OnnxModel(blob, device="cpu"), jonnx.OnnxModel(blob)):
        with pytest.raises(NotImplementedError, match="count_include_pad"):
            model(_X2)
    blob = _graph("Erf", [("x", _X2, 0)], {})
    with pytest.raises(NotImplementedError, match="Erf"):
        tonnx.OnnxModel(blob, device="cpu")(_X2)


def test_executor_keeps_float32_and_host_shapes():
    """A float64 0-d operand does not promote a float32 graph, and int64
    shape values stay on the host."""
    blob = _graph("Mul", [("x", _X1, 0), ("y", np.asarray(0.5, np.float64), 1)], {})
    assert tonnx.OnnxModel(blob, device="cpu")(_X1)[0].dtype == np.float32
    blob = _graph("Shape", [("x", _X2, 0)], {})
    model = tonnx.OnnxModel(blob, device="cpu")
    out = model.run(torch.from_numpy(_X2))[0]
    assert isinstance(out, np.ndarray) and out.tolist() == list(_X2.shape)


# ---------------------------------------------------------------------------
# the DNSMOS models
# ---------------------------------------------------------------------------


def _dnsmos_inputs(name):
    rng = np.random.default_rng(5)
    if name == "sig_bak_ovr":  # tests/eval/test_metrics.py:67 and a seeded waveform
        return [np.zeros((1, 144160), np.float32),
                (rng.standard_normal((2, 144160)) * 0.1).astype(np.float32)]
    return [np.random.default_rng(0).random((1, 200, 120)).astype(np.float32),  # :75
            rng.uniform(-1, 1, (2, 900, 120)).astype(np.float32)]


@pytest.mark.parametrize("name", MODELS)
def test_dnsmos_models_match_jax(name):
    path = os.path.join(os.path.dirname(tonnx.__file__), "..", "assets", "dnsmos", f"{name}.onnx")
    port, ref = tonnx.OnnxModel(path, device="cpu"), jonnx.OnnxModel(path)
    assert port.input_names == ref.input_names == ["input_1"]
    for x in _dnsmos_inputs(name):
        got, want = port(x)[0], np.asarray(ref(x)[0])
        assert got.shape == want.shape == (x.shape[0], 3 if name == "sig_bak_ovr" else 1)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got, port(x)[0])  # deterministic


def test_executor_takes_and_gives_numpy():
    """The port's executor takes numpy and gives numpy, as JAX's does."""
    blob = _graph("Relu", [("x", _X1, 0)], {})
    out = tonnx.OnnxModel(blob, device="cpu")(np.asarray(jnp.asarray(_X1)))
    assert isinstance(out[0], np.ndarray)
    np.testing.assert_array_equal(out[0], np.maximum(_X1, 0))
