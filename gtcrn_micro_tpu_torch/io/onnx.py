"""Minimal ONNX model loader and a PyTorch executor (the JAX package's
``io/onnx.py``).

The reference scores DNSMOS by running bundled ONNX models through
onnxruntime (eval/eval_nonintrusive_dnsmos.py:87-93).  Neither ``onnx`` nor
``onnxruntime`` is needed here:

1. a dependency-free protobuf wire-format parser for the ONNX subset
   (ModelProto -> GraphProto -> Node/Tensor/Attribute), numpy only and the
   same code as the JAX package's;
2. a PyTorch interpreter over the JAX executor's op set (the DNSMOS models'
   Conv, MatMul, MaxPool, Relu, elementwise arithmetic and shape ops, and
   what ``io/onnx_export.py`` emits), running eagerly on the model's
   device.

Values flow as tensors on the device, except int64 values that carry
shapes (int64 initializers, ``Shape``, and what is computed from them
alone), which stay numpy arrays on the host so that no node waits for the
device to learn a shape.  Float32 products and convolutions run without
TF32 (``nn.core.exact_f32``): DNSMOS's log-power front end amplifies a TF32
product's error.  Binary ops keep the ONNX type of their first operand, so
a torch type promotion never turns a float32 graph into float64.

This is an interpreter for small inference graphs, not a general ONNX
importer; unsupported ops raise immediately with the op name.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch
import torch.nn.functional as tF

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.nn.core import exact_f32

# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------


def _read_varint(b: bytes, i: int) -> tuple[int, int]:
    r = s = 0
    while True:
        x = b[i]
        i += 1
        r |= (x & 0x7F) << s
        if not x & 0x80:
            return r, i
        s += 7


def _fields(b: bytes):
    """Yield (field_number, wire_type, value) triplets."""
    i = 0
    while i < len(b):
        tag, i = _read_varint(b, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(b, i)
        elif wt == 1:
            v = b[i : i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(b, i)
            v = b[i : i + ln]
            i += ln
        elif wt == 5:
            v = b[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fn, wt, v


def _packed_varints(b: bytes) -> list[int]:
    out, i = [], 0
    while i < len(b):
        v, i = _read_varint(b, i)
        out.append(v)
    return out


def _signed(v: int) -> int:
    """Interpret a varint as two's-complement int64."""
    return v - (1 << 64) if v >= 1 << 63 else v


# ---------------------------------------------------------------------------
# ONNX schema subset
# ---------------------------------------------------------------------------

_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
}


def _parse_tensor(b: bytes) -> tuple[str, np.ndarray]:
    dims, dtype, raw, name = [], 1, None, ""
    float_data, int64_data, int32_data = [], [], []
    for fn, wt, v in _fields(b):
        if fn == 1:
            if wt == 0:
                dims.append(_signed(v))
            else:
                dims.extend(_signed(x) for x in _packed_varints(v))
        elif fn == 2:
            dtype = v
        elif fn == 4:
            if wt == 5:
                float_data.append(struct.unpack("<f", v)[0])
            else:
                float_data.extend(
                    struct.unpack(f"<{len(v) // 4}f", v)
                )
        elif fn == 5:
            if wt == 0:
                int32_data.append(_signed(v))
            else:
                int32_data.extend(_signed(x) for x in _packed_varints(v))
        elif fn == 7:
            if wt == 0:
                int64_data.append(_signed(v))
            else:
                int64_data.extend(_signed(x) for x in _packed_varints(v))
        elif fn == 8:
            name = v.decode()
        elif fn == 9:
            raw = v
    np_dtype = _DTYPES[dtype]
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif float_data:
        arr = np.array(float_data, dtype=np_dtype)
    elif int64_data:
        arr = np.array(int64_data, dtype=np_dtype)
    elif int32_data:
        arr = np.array(int32_data, dtype=np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    return name, arr.reshape(dims)


def _parse_attribute(b: bytes) -> tuple[str, object]:
    name, atype = "", 0
    f = i = s = t = None
    floats, ints = [], []
    for fn, wt, v in _fields(b):
        if fn == 1:
            name = v.decode()
        elif fn == 2:
            f = struct.unpack("<f", v)[0]
        elif fn == 3:
            i = _signed(v)
        elif fn == 4:
            s = v
        elif fn == 5:
            t = _parse_tensor(v)[1]
        elif fn == 7:
            if wt == 5:
                floats.append(struct.unpack("<f", v)[0])
            else:
                floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
        elif fn == 8:
            if wt == 0:
                ints.append(_signed(v))
            else:
                ints.extend(_signed(x) for x in _packed_varints(v))
        elif fn == 20:
            atype = v
    value = {1: f, 2: i, 3: s, 4: t, 6: floats, 7: ints}.get(atype)
    if value is None:  # attribute type unset: fall back on whichever is set
        value = next(
            (x for x in (f, i, s, t) if x is not None), ints or floats
        )
    return name, value


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict


@dataclasses.dataclass
class OnnxGraph:
    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]
    inputs: list[str]
    outputs: list[str]


def _parse_value_info_name(b: bytes) -> str:
    for fn, _wt, v in _fields(b):
        if fn == 1:
            return v.decode()
    return ""


def _parse_node(b: bytes) -> OnnxNode:
    inputs, outputs, attrs, op_type = [], [], {}, ""
    for fn, _wt, v in _fields(b):
        if fn == 1:
            inputs.append(v.decode())
        elif fn == 2:
            outputs.append(v.decode())
        elif fn == 4:
            op_type = v.decode()
        elif fn == 5:
            k, val = _parse_attribute(v)
            attrs[k] = val
    return OnnxNode(op_type, inputs, outputs, attrs)


def _parse_graph(b: bytes) -> OnnxGraph:
    nodes, inits, inputs, outputs = [], {}, [], []
    for fn, _wt, v in _fields(b):
        if fn == 1:
            nodes.append(_parse_node(v))
        elif fn == 5:
            name, arr = _parse_tensor(v)
            inits[name] = arr
        elif fn == 11:
            inputs.append(_parse_value_info_name(v))
        elif fn == 12:
            outputs.append(_parse_value_info_name(v))
    inputs = [n for n in inputs if n not in inits]
    return OnnxGraph(nodes, inits, inputs, outputs)


def load_onnx(path: str | bytes) -> OnnxGraph:
    """Parse an .onnx file (path or raw bytes) into an OnnxGraph (no onnx
    package needed)."""
    data = path if isinstance(path, (bytes, bytearray)) else open(path, "rb").read()
    for fn, _wt, v in _fields(data):
        if fn == 7:  # ModelProto.graph
            return _parse_graph(v)
    raise ValueError(f"{path}: no graph found")


# ---------------------------------------------------------------------------
# PyTorch interpreter
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {
    1: torch.float32, 2: torch.uint8, 3: torch.int8, 4: torch.uint16, 5: torch.int16,
    6: torch.int32, 7: torch.int64, 9: torch.bool, 10: torch.float16, 11: torch.float64,
}


def _host(v) -> np.ndarray:
    """A value as a numpy array (shapes, axes, pads: host values)."""
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _dev(v, like: torch.Tensor) -> torch.Tensor:
    """A value as a tensor on ``like``'s device (host values are copied)."""
    return v if torch.is_tensor(v) else torch.from_numpy(np.array(v)).to(like.device)


def _ints(v) -> list[int]:
    return [int(a) for a in np.atleast_1d(_host(v))]


def _on_host(fn):
    """``fn`` over torch tensors; where every input is a host (numpy) value
    it runs on CPU tensors and returns numpy, so shape arithmetic stays on
    the host."""
    def op(node, *args):
        if any(torch.is_tensor(a) for a in args):
            like = next(a for a in args if torch.is_tensor(a))
            return fn(node, *(None if a is None else _dev(a, like) for a in args))
        out = fn(node, *(None if a is None else torch.from_numpy(np.array(a)) for a in args))
        return out.numpy() if torch.is_tensor(out) else out
    return op


def _binary(fn, keep_type=True):
    """A binary op whose result keeps the first operand's type (ONNX types
    both operands alike; Pow's exponent may differ)."""
    def op(node, a, b):
        out = fn(a, b)
        return out.to(a.dtype) if keep_type and out.dtype != a.dtype else out
    return _on_host(op)


def _unary(fn):
    return _on_host(lambda node, a: fn(a))


def _pad_list(begins, ends) -> list[int]:
    """ONNX per-axis (begin, end) pads, first axis first -> ``F.pad``'s
    list, last axis first."""
    out: list[int] = []
    for b, e in zip(reversed(list(begins)), reversed(list(ends))):
        out += [int(b), int(e)]
    return out


def _conv_pads(node, x, w, strides, dilations) -> list[tuple[int, int]]:
    a = node.attrs
    pads = a.get("pads")
    auto = a.get("auto_pad", b"NOTSET")
    n = w.dim() - 2
    if pads:
        return list(zip(pads[:n], pads[n:]))
    if auto in (b"SAME_UPPER", b"SAME_LOWER"):
        # ONNX puts the odd pad element at the END for SAME_UPPER and at the
        # BEGINNING for SAME_LOWER
        out = []
        for i in range(n):
            in_sz = x.shape[2 + i]
            k_eff = (w.shape[2 + i] - 1) * dilations[i] + 1
            out_sz = -(-in_sz // strides[i])
            total = max((out_sz - 1) * strides[i] + k_eff - in_sz, 0)
            small, big = total // 2, total - total // 2
            out.append((small, big) if auto == b"SAME_UPPER" else (big, small))
        return out
    return [(0, 0)] * n


_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}


def _op_conv(node, x, w, b=None):
    a = node.attrs
    n = w.dim() - 2
    strides = list(a.get("strides", [1] * n))
    dilations = list(a.get("dilations", [1] * n))
    pads = _conv_pads(node, x, w, strides, dilations)
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:  # asymmetric: pad explicitly, then a valid conv
        x = tF.pad(x, _pad_list(*zip(*pads)))
        padding = [0] * n
    out = _CONV[n](x, w, None, strides, padding, dilations, a.get("group", 1))
    if b is not None:  # after the conv, as the JAX executor adds it
        out = out + b.reshape((1, -1) + (1,) * n)
    return out


_MAXPOOL = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}


def _pool_geometry(node):
    k = list(node.attrs["kernel_shape"])
    strides = list(node.attrs.get("strides", k))
    pads = list(node.attrs.get("pads", [0] * (2 * len(k))))
    return k, strides, pads[: len(k)], pads[len(k):]


def _op_maxpool(node, x):
    k, strides, lo, hi = _pool_geometry(node)
    if any(lo) or any(hi):  # pad with -inf, as the JAX executor's reduce_window does
        x = tF.pad(x, _pad_list(lo, hi), value=-float("inf"))
    return _MAXPOOL[len(k)](x, k, strides)


def _op_avgpool(node, x):
    k, strides, lo, hi = _pool_geometry(node)
    if (any(lo) or any(hi)) and not node.attrs.get("count_include_pad", 0):
        raise NotImplementedError("AveragePool with pads and count_include_pad=0")
    if any(lo) or any(hi):
        x = tF.pad(x, _pad_list(lo, hi))
    if len(k) == 1:  # the window sum, then one division, as the JAX executor does
        summed = tF.avg_pool2d(x[..., None], (k[0], 1), (strides[0], 1), divisor_override=1)[..., 0]
    else:
        pool = {2: tF.avg_pool2d, 3: tF.avg_pool3d}[len(k)]
        summed = pool(x, k, strides, divisor_override=1)
    return summed / float(np.prod(k))


def _slice_index(dim: int, st: int, en: int, sp: int):
    """Python slicing of ``range(dim)``, with the JAX executor's end clamp."""
    en = min(en, dim) if en >= 0 else en
    return range(dim)[slice(st, en, sp)]


def _op_slice(node, data, *rest):
    if rest:  # opset >= 10: starts/ends/axes/steps as inputs
        starts, ends = _ints(rest[0]), _ints(rest[1])
        axes = _ints(rest[2]) if len(rest) > 2 and rest[2] is not None else list(range(len(starts)))
        steps = _ints(rest[3]) if len(rest) > 3 and rest[3] is not None else [1] * len(starts)
    else:  # opset 1: attributes
        starts, ends = list(node.attrs["starts"]), list(node.attrs["ends"])
        axes = list(node.attrs.get("axes", range(len(starts))))
        steps = [1] * len(starts)
    host = not torch.is_tensor(data)
    x = torch.from_numpy(np.array(data)) if host else data
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = ax % x.dim()
        r = _slice_index(x.shape[ax], st, en, sp)
        if sp > 0:
            x = x[(slice(None),) * ax + (slice(r.start, r.start + len(r) * sp, sp),)]
        else:  # torch slices take no negative step
            x = x.index_select(ax, torch.tensor(list(r), dtype=torch.long, device=x.device))
    return x.numpy() if host else x


def _axes(node, axes):
    if axes is None:
        axes = node.attrs.get("axes")
    return None if axes is None else tuple(_ints(axes))


def _reduce(fn):
    def op(node, x, axes=None):
        ax = _axes(node, axes)
        return fn(x, dim=tuple(range(x.dim())) if ax is None else ax,
                  keepdim=bool(node.attrs.get("keepdims", 1)))
    return _on_host(op)


def _op_reduce_mean(node, x):
    ax = tuple(int(a) for a in node.attrs.get("axes", [])) or tuple(range(x.dim()))
    return torch.mean(x, dim=ax, keepdim=bool(node.attrs.get("keepdims", 1)))


def _op_unsqueeze(node, x, axes=None):
    for ax in sorted(_axes(node, axes)):
        x = x.unsqueeze(ax)
    return x


def _op_squeeze(node, x, axes=None):
    ax = _axes(node, axes)
    return x.squeeze() if ax is None else x.squeeze(ax)


def _op_reshape(node, x, shape):
    shape = _ints(shape)
    # ONNX: 0 copies the input's dim (allowzero unset), -1 is inferred
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


def _op_pad(node, x, pads, value=None, axes=None):
    mode = node.attrs.get("mode", b"constant")
    if mode != b"constant":
        raise NotImplementedError(f"Pad mode {mode!r}")
    pads = _ints(pads)
    half = len(pads) // 2
    if axes is not None:
        full = [0] * (2 * x.dim())
        for i, ax in enumerate(_ints(axes)):
            full[ax] = pads[i]
            full[x.dim() + ax] = pads[half + i]
        pads, half = full, x.dim()
    cval = 0.0 if value is None else _host(value).ravel()[0].item()
    return tF.pad(x, _pad_list(pads[:half], pads[half:]), value=cval)


def _op_gemm(node, a, b, c=None):
    a = a.t() if node.attrs.get("transA") else a
    b = b.t() if node.attrs.get("transB") else b
    out = torch.matmul(a, b) * node.attrs.get("alpha", 1.0)
    return out if c is None else out + node.attrs.get("beta", 1.0) * c


def _op_expand(node, x, shape):
    out = np.broadcast_shapes(tuple(x.shape), tuple(_ints(shape)))
    return x.expand(out)


def _op_cast(node, x):
    to = node.attrs["to"]
    if torch.is_tensor(x):
        return x.to(_TORCH_DTYPES[to])
    return np.asarray(x).astype(_DTYPES[to])


def _op_concat(node, *xs):
    if not any(torch.is_tensor(x) for x in xs):
        return np.concatenate(xs, axis=node.attrs["axis"])
    like = next(x for x in xs if torch.is_tensor(x))
    return torch.cat([_dev(x, like) for x in xs], dim=node.attrs["axis"])


def _variadic(fn):
    def op(node, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = fn(out, x)
        return out
    return _on_host(op)


_OPS = {
    "Add": _binary(torch.add),
    "Sub": _binary(torch.sub),
    "Mul": _binary(torch.mul),
    "Div": _binary(torch.div),
    "Pow": _binary(torch.pow),
    "Sqrt": _unary(torch.sqrt),
    "Log": _unary(torch.log),
    "Exp": _unary(torch.exp),
    "Abs": _unary(torch.abs),
    "Neg": _unary(torch.neg),
    "Max": _variadic(torch.maximum),
    "Min": _variadic(torch.minimum),
    "Relu": _unary(torch.relu),
    "Sigmoid": _unary(torch.sigmoid),
    "Tanh": _unary(torch.tanh),
    "MatMul": _on_host(lambda n, a, b: torch.matmul(a, b)),
    "Gemm": _on_host(_op_gemm),
    "Conv": _on_host(_op_conv),
    "MaxPool": _on_host(_op_maxpool),
    "AveragePool": _on_host(_op_avgpool),
    "GlobalAveragePool": _on_host(
        lambda n, x: torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)),
    "Transpose": _on_host(lambda n, x: x.permute(
        n.attrs.get("perm") or list(reversed(range(x.dim()))))),
    "Reshape": _on_host(_op_reshape),
    "Concat": _op_concat,
    "Squeeze": _on_host(_op_squeeze),
    "Unsqueeze": _on_host(_op_unsqueeze),
    "Slice": _op_slice,
    "ReduceMax": _reduce(torch.amax),
    "ReduceMean": _on_host(_op_reduce_mean),
    "Flatten": _on_host(lambda n, x: x.reshape(
        int(np.prod(x.shape[: n.attrs.get("axis", 1)])), -1)),
    "ReduceSum": _reduce(torch.sum),
    "Expand": _on_host(_op_expand),
    "Reciprocal": _unary(torch.reciprocal),
    "Where": _on_host(lambda n, c, a, b: torch.where(c, a, b)),
    "Greater": _binary(torch.gt, keep_type=False),
    "Less": _binary(torch.lt, keep_type=False),
    "Equal": _binary(torch.eq, keep_type=False),
    "GreaterOrEqual": _binary(torch.ge, keep_type=False),
    "LessOrEqual": _binary(torch.le, keep_type=False),
    "And": _binary(torch.logical_and),
    "Or": _binary(torch.logical_or),
    "Not": _unary(torch.logical_not),
    "Pad": _on_host(_op_pad),
    "Sign": _unary(torch.sign),
    "Floor": _unary(torch.floor),
    "Ceil": _unary(torch.ceil),
    "PRelu": _on_host(lambda n, x, slope: torch.where(x > 0, x, slope * x)),
    "Identity": lambda n, x: x,
    "Cast": _op_cast,
    "Shape": lambda n, x: np.asarray(x.shape, np.int64),
    "Clip": _on_host(lambda n, x, lo=None, hi=None: torch.clamp(x, lo, hi)),
}


class OnnxModel:
    """Executable ONNX graph: ``OnnxModel(path)(input_array)``.

    Float initializers live on ``device`` (``None``: CUDA), int64 ones on the
    host.  ``__call__`` takes numpy arrays and returns numpy arrays, as the
    JAX executor does; float64 inputs are cast to float32, as JAX's default
    does.  The graph runs eagerly, node by node, without TF32.
    """

    def __init__(self, path: str | bytes, device=None):
        self.device = resolve_device(device)
        self.graph = load_onnx(path)
        self.params = {
            k: v if v.dtype == np.int64 else torch.from_numpy(np.array(v)).to(self.device)
            for k, v in self.graph.initializers.items()
        }
        self.input_names = self.graph.inputs
        self.output_names = self.graph.outputs

    def run(self, *tensors) -> list:
        """The graph over its inputs as they are (tensors on the device, or
        host values); returns the outputs as the graph left them."""
        env = dict(self.params)
        env.update(zip(self.input_names, tensors))
        with torch.no_grad(), exact_f32():
            for node in self.graph.nodes:
                fn = _OPS.get(node.op_type)
                if fn is None:
                    raise NotImplementedError(f"ONNX op {node.op_type!r} not supported")
                args = [env[name] if name else None for name in node.inputs]
                out = fn(node, *args)
                outs = out if isinstance(out, (tuple, list)) else [out]
                for name, val in zip(node.outputs, outs):
                    env[name] = val
        return [env[name] for name in self.output_names]

    def __call__(self, *arrays) -> list:
        inputs = []
        for a in arrays:
            a = np.asarray(a)
            a = a.astype(np.float32) if a.dtype == np.float64 else a
            inputs.append(torch.from_numpy(np.array(a)).to(self.device))
        return [_host(o) for o in self.run(*inputs)]
