"""ONNX emission: lower a ``torch.export`` program to an ONNX (opset 16)
file (the JAX package's ``io/onnx_export.py``).

The reference exports its graph with ``torch.onnx.export`` (opset 16, static
shapes, input "audio"; streaming/conversion/stream_onnx.py:15-129), which
needs the ``onnx`` package.  Here, as in the JAX package, the file is
written by a dependency-free protobuf encoder (the same code as JAX's), and
the graph comes from ``torch.export.export(...).run_decompositions()``: each
ATen operation of the exported program is mapped to ONNX ops, where JAX maps
the primitives of a jaxpr.

Properties:

- the program's lifted parameters, buffers and constants become ONNX
  initializers; nodes whose inputs are all constant are folded at export
  time on the host (BatchNorm's ``rsqrt(var+eps)*gamma`` chains collapse
  into plain Mul/Add initializers, weight permutes into the initializer);
- the state tensors the step updates in place (the program's
  ``user_inputs_to_mutate``) become the ``<name>.out`` outputs, after the
  function's own outputs and in the order of the inputs;
- only ops that both executors implement are emitted (the op set of the JAX
  package's ``io/onnx.py``, which the port's ``io/onnx.py`` shares), so a
  file from either package runs on either executor: no ConvTranspose, no
  ScatterND.  The layered model's transposed convs are plain convs over a
  zero-stuffed input (``nn/core.CausalConv2d``); the stuffing
  (``slice_scatter`` with a step) lowers to Unsqueeze/Concat/Reshape/Slice,
  the JAX emitter's ``_zero_stuff``;
- ``aten._assert_tensor_metadata`` (a no-op) is dropped.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

# ---------------------------------------------------------------------------
# protobuf wire-format encoder (mirror of io/onnx.py's decoder; the JAX
# package's code)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _f_varint(fn: int, v: int) -> bytes:
    if v < 0:  # two's-complement int64
        v += 1 << 64
    return _varint(fn << 3) + _varint(v)


def _f_bytes(fn: int, b: bytes) -> bytes:
    return _varint((fn << 3) | 2) + _varint(len(b)) + b


def _f_float(fn: int, v: float) -> bytes:
    return _varint((fn << 3) | 5) + struct.pack("<f", v)


_ONNX_DTYPE = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.uint16): 4, np.dtype(np.int16): 5, np.dtype(np.int32): 6,
    np.dtype(np.int64): 7, np.dtype(np.bool_): 9, np.dtype(np.float16): 10,
    np.dtype(np.float64): 11,
}


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b"".join(_f_varint(1, int(d)) for d in arr.shape)
    out += _f_varint(2, _ONNX_DTYPE[arr.dtype])
    out += _f_bytes(8, name.encode())
    out += _f_bytes(9, arr.tobytes())
    return out


def _attr(name: str, value) -> bytes:
    out = _f_bytes(1, name.encode())
    if isinstance(value, (bytes, str)):
        v = value.encode() if isinstance(value, str) else value
        out += _f_bytes(4, v) + _f_varint(20, 3)  # STRING
    elif isinstance(value, bool) or isinstance(value, (int, np.integer)):
        out += _f_varint(3, int(value)) + _f_varint(20, 2)  # INT
    elif isinstance(value, float):
        out += _f_float(2, value) + _f_varint(20, 1)  # FLOAT
    elif isinstance(value, np.ndarray):
        out += _f_bytes(5, _tensor_proto("", value)) + _f_varint(20, 4)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            out += b"".join(_f_float(7, float(v)) for v in value)
            out += _f_varint(20, 6)  # FLOATS
        else:
            out += b"".join(_f_varint(8, int(v)) for v in value)
            out += _f_varint(20, 7)  # INTS
    else:
        raise TypeError(f"attribute {name}: unsupported type {type(value)}")
    return out


def _node_proto(op_type: str, inputs, outputs, attrs: dict) -> bytes:
    out = b"".join(_f_bytes(1, n.encode()) for n in inputs)
    out += b"".join(_f_bytes(2, n.encode()) for n in outputs)
    out += _f_bytes(4, op_type.encode())
    out += b"".join(_f_bytes(5, _attr(k, v)) for k, v in attrs.items())
    return out


def _value_info(name: str, shape, dtype) -> bytes:
    dims = b"".join(
        _f_bytes(1, _f_varint(1, int(d))) for d in shape
    )
    tensor_type = _f_varint(1, _ONNX_DTYPE[np.dtype(dtype)])
    tensor_type += _f_bytes(2, dims)
    return _f_bytes(1, name.encode()) + _f_bytes(2, _f_bytes(1, tensor_type))


def _model_proto(graph: bytes, opset: int = 16) -> bytes:
    out = _f_varint(1, 8)  # ir_version 8
    out += _f_bytes(2, b"gtcrn_micro_tpu")
    out += _f_bytes(7, graph)
    out += _f_bytes(8, _f_bytes(1, b"") + _f_varint(2, opset))
    return out


# ---------------------------------------------------------------------------
# torch.export (ATen) -> ONNX lowering
# ---------------------------------------------------------------------------

# Values flowing through the emitter: np.ndarray = compile-time constant,
# str = symbolic ONNX tensor name.

_aten = torch.ops.aten
_I64_MAX = 2**63 - 1


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy()


def _meta(node):
    """(shape, numpy dtype) of an fx node's value."""
    v = node.meta["val"]
    return tuple(int(d) for d in v.shape), _np(torch.empty((), dtype=v.dtype)).dtype


class _Emitter:
    def __init__(self):
        self.nodes: list[bytes] = []
        self.initializers: dict[str, np.ndarray] = {}
        self._init_by_id: dict[int, str] = {}
        self._n = 0
        self.env: dict = {}

    def fresh(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def sym(self, val) -> str:
        """Symbol name for a value; constants become initializers."""
        if isinstance(val, str):
            return val
        key = id(val)
        name = self._init_by_id.get(key)
        if name is None:
            name = self.fresh("const")
            self.initializers[name] = val
            self._init_by_id[key] = name
        return name

    def const_i64(self, values) -> str:
        return self.sym(np.asarray(values, np.int64))

    def node(self, op: str, args, n_out: int = 1, **attrs):
        outs = [self.fresh(op.lower()) for _ in range(n_out)]
        self.nodes.append(_node_proto(op, [self.sym(a) for a in args], outs, attrs))
        return outs[0] if n_out == 1 else outs

    def read(self, arg):
        """An fx argument: a node's value, or a Python value as is."""
        if isinstance(arg, torch.fx.Node):
            return self.env[arg]
        if isinstance(arg, (list, tuple)):
            return [self.read(a) for a in arg]
        return arg

    def process(self, graph) -> None:
        for node in graph.nodes:
            if node.op != "call_function":
                continue
            args = [self.read(a) for a in node.args]
            kwargs = {k: self.read(v) for k, v in node.kwargs.items()}
            if node.target is _aten._assert_tensor_metadata.default:
                continue
            if not _symbolic(args) and not _symbolic(list(kwargs.values())):
                # fold on the host: every input is a constant
                out = node.target(*_to_torch(args), **_to_torch(kwargs))
                self.env[node] = _np(out) if torch.is_tensor(out) else out
                continue
            handler = _HANDLERS.get(node.target)
            if handler is None:
                raise NotImplementedError(f"ONNX export: unsupported op {node.target}")
            self.env[node] = handler(self, node, *args, **kwargs)


def _symbolic(values) -> bool:
    return any(isinstance(v, str) or (isinstance(v, list) and _symbolic(v)) for v in values)


def _to_torch(v):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v)
    if isinstance(v, list):
        return [_to_torch(x) for x in v]
    if isinstance(v, dict):
        return {k: _to_torch(x) for k, x in v.items()}
    return v


def _dim(node, i=0) -> int:
    return len(_meta(node.args[i])[0])


def _scalar(node, v):
    """A Python scalar operand as a 0-d constant of the node's dtype (torch
    does not promote a tensor by a scalar; ONNX types both operands
    alike)."""
    if isinstance(v, (bool, int, float)):
        return np.asarray(v, _meta(node)[1])
    return v


def _binary(op):
    def handler(self, node, a, b, alpha=1):
        b = _scalar(node, b)
        if alpha != 1:
            b = self.node("Mul", [b, np.asarray(alpha, _meta(node)[1])])
        return self.node(op, [_scalar(node, a), b])
    return handler


def _compare(op):
    def handler(self, node, a, b):
        dtype = _meta(node.args[0])[1]
        a, b = (np.asarray(v, dtype) if isinstance(v, (bool, int, float)) else v for v in (a, b))
        return self.node(op, [a, b])
    return handler


def _unary(op):
    return lambda self, node, x: self.node(op, [x])


def _rsqrt(self, node, x):
    return self.node("Reciprocal", [self.node("Sqrt", [x])])


def _pow(self, node, x, y):
    if y == 2:
        return self.node("Mul", [x, x])
    return self.node("Pow", [x, _scalar(node, y)])


def _addmm(self, node, bias, m1, m2, beta=1, alpha=1):
    if beta != 1 or alpha != 1:
        raise NotImplementedError("addmm with beta or alpha != 1")
    return self.node("Add", [self.node("MatMul", [m1, m2]), bias])


def _matmul(self, node, a, b):
    return self.node("MatMul", [a, b])


def _convolution(self, node, x, w, b, stride, padding, dilation, transposed,
                 output_padding, groups):
    if transposed:
        raise NotImplementedError(
            "ONNX export: transposed convolution (no ConvTranspose in the executors' "
            "op set; the layered model zero-stuffs its transposed convs)")
    pads = [int(p) for p in padding]
    args = [x, w] + ([] if b is None else [b])
    return self.node("Conv", args, strides=[int(s) for s in stride],
                     dilations=[int(d) for d in dilation], pads=pads + pads,
                     group=int(groups))


def _constant_pad_nd(self, node, x, pad, value=0):
    n = _dim(node)
    begins, ends = [0] * n, [0] * n
    for i in range(len(pad) // 2):  # torch: last axis first
        begins[n - 1 - i], ends[n - 1 - i] = int(pad[2 * i]), int(pad[2 * i + 1])
    if any(p < 0 for p in begins + ends):
        raise NotImplementedError("constant_pad_nd with negative padding")
    return self.node("Pad", [x, self.const_i64(begins + ends), _scalar(node, value)])


def _cat(self, node, tensors, dim=0):
    return self.node("Concat", tensors, axis=int(dim) % len(_meta(node)[0]))


def _slice_node(self, x, starts, ends, axes, steps):
    return self.node("Slice", [x, self.const_i64(starts), self.const_i64(ends),
                               self.const_i64(axes), self.const_i64(steps)])


def _slice(self, node, x, dim=0, start=None, end=None, step=1):
    shape = _meta(node.args[0])[0]
    dim = int(dim) % len(shape)
    r = range(shape[dim])[slice(start, None if end is None else min(int(end), _I64_MAX), step)]
    if r.start == 0 and len(r) == shape[dim] and r.step == 1:
        return x
    return _slice_node(self, x, [r.start], [r.start + len(r) * r.step], [dim], [r.step])


def _select(self, node, x, dim, index):
    shape = _meta(node.args[0])[0]
    dim, index = int(dim) % len(shape), int(index) % shape[int(dim) % len(shape)]
    out = _slice_node(self, x, [index], [index + 1], [dim], [1])
    return self.node("Squeeze", [out, self.const_i64([dim])])


def _reshape(self, node, x, *shape):
    out = _meta(node)[0]
    if out == _meta(node.args[0])[0]:
        return x
    return self.node("Reshape", [x, self.const_i64(out)])


def _permute(self, node, x, dims):
    n = len(dims)
    perm = [int(d) % n for d in dims]
    if perm == list(range(n)):
        return x
    return self.node("Transpose", [x], perm=perm)


def _unsqueeze(self, node, x, dim):
    return self.node("Unsqueeze", [x, self.const_i64([int(dim) % len(_meta(node)[0])])])


def _squeeze(self, node, x, dims=None):
    shape = _meta(node.args[0])[0]
    dims = [d for d in range(len(shape)) if shape[d] == 1] if dims is None else (
        [dims] if isinstance(dims, int) else list(dims))
    dims = [int(d) % len(shape) for d in dims if shape[int(d) % len(shape)] == 1]
    if not dims:
        return x
    return self.node("Squeeze", [x, self.const_i64(dims)])


def _expand(self, node, x, size, implicit=False):
    out = _meta(node)[0]
    if out == _meta(node.args[0])[0]:
        return x
    return self.node("Expand", [x, self.const_i64(out)])


def _copy(self, node, dst, src, non_blocking=False):
    """``dst`` overwritten by ``src``: ``src`` broadcast and cast to
    ``dst``'s shape and type."""
    shape, dtype = _meta(node)
    if isinstance(src, np.ndarray):
        return np.ascontiguousarray(np.broadcast_to(src, shape).astype(dtype))
    s_shape, s_dtype = _meta(node.args[1])
    if s_dtype != dtype:
        src = self.node("Cast", [src], to=_ONNX_DTYPE[dtype])
    if s_shape != shape:
        src = self.node("Expand", [src, self.const_i64(shape)])
    return src


def _to_copy(self, node, x, **kwargs):
    dtype = _meta(node)[1]
    if dtype == _meta(node.args[0])[1]:
        return x
    return self.node("Cast", [x], to=_ONNX_DTYPE[dtype])


def _zero_stuff(self, x, shape, axis, factor):
    """Interleave ``factor - 1`` zeros after each element along ``axis``
    (the JAX emitter's ``_zero_stuff``).  Returns (symbol, new_shape)."""
    d = shape[axis]
    unsq = self.node("Unsqueeze", [x, self.const_i64([axis + 1])])
    zshape = list(shape[: axis + 1]) + [factor - 1] + list(shape[axis + 1:])
    cat = self.node("Concat", [unsq, np.zeros(zshape, np.float32)], axis=axis + 1)
    merged = list(shape)
    merged[axis] = d * factor
    out = self.node("Reshape", [cat, self.const_i64(merged)])
    new_d = (d - 1) * factor + 1
    ends = list(merged)
    ends[axis] = new_d
    out = _slice_node(self, out, [0] * len(shape), ends, list(range(len(shape))),
                      [1] * len(shape))
    merged[axis] = new_d
    return out, merged


def _slice_scatter(self, node, base, src, dim=0, start=None, end=None, step=1):
    """``base`` with ``src`` written over ``base[start:end:step]`` along
    ``dim``: ``src`` zero-stuffed and padded to ``base``'s shape, then
    selected by a constant mask (no ScatterND)."""
    shape, dtype = _meta(node)
    dim = int(dim) % len(shape)
    r = range(shape[dim])[slice(start, end, step)]
    src_shape = list(_meta(node.args[1])[0])
    if step > 1:
        src, src_shape = _zero_stuff(self, src, src_shape, dim, step)
    begins, ends = [0] * len(shape), [0] * len(shape)
    begins[dim], ends[dim] = r.start, shape[dim] - r.start - src_shape[dim]
    if any(begins) or any(ends):
        src = self.node("Pad", [src, self.const_i64(begins + ends), np.zeros((), dtype)])
    if isinstance(base, np.ndarray) and not base.any():
        return src
    mask = np.zeros(shape, np.bool_)
    idx = [slice(None)] * len(shape)
    idx[dim] = slice(r.start, r.stop, r.step)
    mask[tuple(idx)] = True
    return self.node("Where", [mask, src, base])


def _mean(self, node, x, dims, keepdim=False, dtype=None):
    n = _dim(node)
    return self.node("ReduceMean", [x], axes=[int(d) % n for d in dims], keepdims=int(keepdim))


def _sum(self, node, x, dims, keepdim=False, dtype=None):
    n = _dim(node)
    return self.node("ReduceSum", [x, self.const_i64([int(d) % n for d in dims])],
                     keepdims=int(keepdim))


def _where(self, node, c, a, b):
    return self.node("Where", [c, _scalar(node, a), _scalar(node, b)])


def _identity(self, node, x, *args, **kwargs):
    return x


def _full_like(self, node, x, value, **kwargs):
    """A constant of the (static) shape of a symbolic tensor."""
    shape, dtype = _meta(node)
    return np.full(shape, value, dtype)


_HANDLERS = {
    _aten.add.Tensor: _binary("Add"), _aten.add.Scalar: _binary("Add"),
    _aten.sub.Tensor: _binary("Sub"), _aten.sub.Scalar: _binary("Sub"),
    _aten.mul.Tensor: _binary("Mul"), _aten.mul.Scalar: _binary("Mul"),
    _aten.div.Tensor: _binary("Div"), _aten.div.Scalar: _binary("Div"),
    _aten.maximum.default: _binary("Max"), _aten.minimum.default: _binary("Min"),
    _aten.pow.Tensor_Scalar: _pow,
    _aten.gt.Scalar: _compare("Greater"), _aten.gt.Tensor: _compare("Greater"),
    _aten.lt.Scalar: _compare("Less"), _aten.lt.Tensor: _compare("Less"),
    _aten.ge.Scalar: _compare("GreaterOrEqual"), _aten.ge.Tensor: _compare("GreaterOrEqual"),
    _aten.le.Scalar: _compare("LessOrEqual"), _aten.le.Tensor: _compare("LessOrEqual"),
    _aten.eq.Scalar: _compare("Equal"), _aten.eq.Tensor: _compare("Equal"),
    _aten.where.self: _where,
    _aten.sqrt.default: _unary("Sqrt"), _aten.rsqrt.default: _rsqrt,
    _aten.sigmoid.default: _unary("Sigmoid"), _aten.tanh.default: _unary("Tanh"),
    _aten.relu.default: _unary("Relu"), _aten.neg.default: _unary("Neg"),
    _aten.abs.default: _unary("Abs"), _aten.exp.default: _unary("Exp"),
    _aten.log.default: _unary("Log"), _aten.reciprocal.default: _unary("Reciprocal"),
    _aten.addmm.default: _addmm, _aten.mm.default: _matmul, _aten.bmm.default: _matmul,
    _aten.convolution.default: _convolution,
    _aten.constant_pad_nd.default: _constant_pad_nd,
    _aten.cat.default: _cat,
    _aten.slice.Tensor: _slice, _aten.select.int: _select,
    _aten.view.default: _reshape, _aten._unsafe_view.default: _reshape,
    _aten.reshape.default: _reshape,
    _aten.permute.default: _permute, _aten.unsqueeze.default: _unsqueeze,
    _aten.squeeze.dims: _squeeze,
    _aten.expand.default: _expand,
    _aten.copy.default: _copy, _aten._to_copy.default: _to_copy,
    _aten.clone.default: _identity, _aten.full_like.default: _full_like,
    _aten.slice_scatter.default: _slice_scatter,
    _aten.mean.dim: _mean, _aten.sum.dim_IntList: _sum,
}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


class _Function(torch.nn.Module):
    """``fn`` as a module that owns ``owner`` (so its tensors are the
    program's parameters and buffers)."""

    def __init__(self, fn, owner: torch.nn.Module | None):
        super().__init__()
        self.fn = fn
        self.owner = owner

    def forward(self, *args):
        return self.fn(*args)


def export_onnx(fn, example_args, *, owner: torch.nn.Module | None = None,
                input_names: list[str] | None = None,
                output_names: list[str] | None = None,
                graph_name: str = "torch_graph") -> bytes:
    """Export ``fn(*example_args)`` with ``torch.export`` and emit an ONNX
    (opset 16) model.

    The tensors of ``owner`` (the module ``fn`` runs) and the constants
    ``fn`` closes over become initializers; the tensors of ``example_args``
    (flattened, lists included) become graph inputs.  The outputs are
    ``fn``'s own (a tensor or a flat tuple/list of tensors), then, for each
    input that ``fn`` updates in place, its final value named
    ``<input name>.out``.  Names default to ``input_i`` / ``output_i``.
    """
    program = torch.export.export(_Function(fn, owner), tuple(example_args))
    program = program.run_decompositions()
    sig = program.graph_signature
    flat_args = [t for t in torch.utils._pytree.tree_leaves(tuple(example_args))]
    if input_names is None:
        input_names = [f"input_{i}" for i in range(len(flat_args))]
    user = [s for s in sig.input_specs if s.kind.name == "USER_INPUT"]
    if len(input_names) != len(user):
        raise ValueError(f"{len(input_names)} input names for {len(user)} inputs")
    by_arg = {s.arg.name: name for s, name in zip(user, input_names)}

    em = _Emitter()
    state = program.state_dict
    constants = program.constants
    graph_inputs = []
    placeholders = {n.name: n for n in program.graph.nodes if n.op == "placeholder"}
    for spec in sig.input_specs:
        node = placeholders[spec.arg.name]
        if spec.kind.name == "USER_INPUT":
            em.env[node] = by_arg[spec.arg.name]
            shape, dtype = _meta(node)
            graph_inputs.append(_value_info(by_arg[spec.arg.name], shape, dtype))
        elif spec.target in state:
            em.env[node] = _np(state[spec.target])
        else:
            em.env[node] = _np(constants[spec.target])
    em.process(program.graph)

    out_node = next(n for n in program.graph.nodes if n.op == "output")
    values = list(out_node.args[0])
    user_out = [(v, s) for v, s in zip(values, sig.output_specs) if s.kind.name == "USER_OUTPUT"]
    mutated = {s.target: v for v, s in zip(values, sig.output_specs)
               if s.kind.name == "USER_INPUT_MUTATION"}
    outs = [v for v, _ in user_out]
    mut_names = [by_arg[s.arg.name] for s in user if s.arg.name in mutated]
    outs += [mutated[s.arg.name] for s in user if s.arg.name in mutated]
    if output_names is None:
        output_names = [f"output_{i}" for i in range(len(user_out))]
        output_names += [f"{n}.out" for n in mut_names]
    if len(output_names) != len(outs):
        raise ValueError(f"{len(output_names)} output names for {len(outs)} outputs")

    graph_outputs = []
    for node, name in zip(outs, output_names):
        sym = em.sym(em.read(node))
        if sym != name:  # bind the output name (also a constant output or an input)
            em.nodes.append(_node_proto("Identity", [sym], [name], {}))
        shape, dtype = _meta(node)
        graph_outputs.append(_value_info(name, shape, dtype))

    graph = b"".join(_f_bytes(1, n) for n in em.nodes)
    graph += _f_bytes(2, graph_name.encode())
    graph += b"".join(_f_bytes(5, _tensor_proto(k, v)) for k, v in em.initializers.items())
    graph += b"".join(_f_bytes(11, vi) for vi in graph_inputs)
    graph += b"".join(_f_bytes(12, vi) for vi in graph_outputs)
    return _model_proto(graph)


def export_model_onnx(model, batch: int = 1, frames: int = 63) -> bytes:
    """Offline GTCRN-Micro graph as ONNX: enhanced = f(audio (B,257,T,2)),
    with the weights of ``model`` (a float32 ``models.gtcrn_micro.GTCRNMicro``).

    Matches the reference's export semantics (static shapes, offline graph,
    input "audio"; stream_onnx.py:93-105)."""
    spec = torch.zeros((batch, model.config.n_freqs, frames, 2), device=model.device)
    return export_onnx(model.apply, (spec,), owner=model, input_names=["audio"],
                       output_names=["enhanced"], graph_name="gtcrn_micro")


def export_stream_onnx(model, batch: int = 1) -> bytes:
    """One streaming step as ONNX -- the artifact the reference *names* but
    never produces (stream_onnx.py:12 exports the offline graph instead).

    Inputs: one per shift cache (sorted state keys), then "audio"
    (B,257,1,2); outputs: "enhanced" + the updated caches as ``<key>.out``.
    Shift state keeps the graph static-shape (concat + slice)."""
    state = model.init_state(batch, ring=False)
    keys = sorted(state)
    spec = torch.zeros((batch, model.config.n_freqs, 1, 2), device=model.device)

    def step(caches, s):
        return model.step(dict(zip(keys, caches)), s)[0]

    return export_onnx(step, ([state[k] for k in keys], spec), owner=model,
                       input_names=keys + ["audio"],
                       output_names=["enhanced"] + [f"{k}.out" for k in keys],
                       graph_name="gtcrn_micro_stream")


def export_audio_onnx(model, batch: int = 1, chunk_hops: int = 1) -> bytes:
    """The SERVED audio-in -> audio-out step as ONNX: online STFT ->
    streaming model step -> online iSTFT with all carried state threaded
    (``dsp/stream_dsp.make_audio_step``, the served program).

    The transforms take the GEMM-DFT form (``dft="mxu"``: two MatMuls with
    the window and OLA envelope folded in) because opset 16 has no FFT op.
    Model state is shift state, as in :func:`export_stream_onnx`.

    Inputs: "dsp.in_buf"/"dsp.ola_buf" (B,256), one per shift cache,
    "audio_in" (B, 256*T); outputs "audio_out", then each state input's
    ``.out``.  The output runs one hop behind the input; a fresh stream's
    first emitted chunk is the discarded center-trim region (online-DSP
    contract, dsp/stream_dsp.py).
    """
    from gtcrn_micro_tpu_torch.dsp import stream_dsp
    from gtcrn_micro_tpu_torch.dsp.stft import sqrt_hann_window

    window = sqrt_hann_window(model.config.win_len, device=model.device)
    step = stream_dsp.make_audio_step(model, window, dft="mxu")
    state = model.init_state(batch, ring=False)
    keys = sorted(state)
    dsp0 = stream_dsp.init_dsp_state(batch, device=model.device)
    chunk = torch.zeros((batch, 256 * chunk_hops), device=model.device)

    def fn(in_buf, ola_buf, caches, c):
        out, _, _ = step(stream_dsp.DspState(in_buf, ola_buf), dict(zip(keys, caches)), c)
        return out

    return export_onnx(fn, (dsp0.in_buf, dsp0.ola_buf, [state[k] for k in keys], chunk),
                       owner=model,
                       input_names=["dsp.in_buf", "dsp.ola_buf"] + keys + ["audio_in"],
                       output_names=["audio_out", "dsp.in_buf.out", "dsp.ola_buf.out"]
                       + [f"{k}.out" for k in keys],
                       graph_name="gtcrn_micro_audio")
