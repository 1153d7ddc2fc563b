"""Export model weights for the native C++ runtime (``native/``).

Counterpart of the JAX package's ``io/export_native.py``: the same files,
byte for byte, for the same params and activation params.

GTM1 (float32), little-endian, read by ``native/gtcrn_micro.cc``::

    magic   uint32  0x47544D31  ("GTM1")
    count   uint32  number of tensors
    per tensor:
        rank  uint32
        dims  uint32 x rank
        data  float32 x prod(dims)

The tensors are the 158 entries of ``ops.fused_step.pack_weights`` (BN
folded), in its order, each in the JAX package's packed shape: the port packs
the same values without the trailing singleton dims that Mosaic needed, so
:func:`_packed` puts them back (a bias ``(C,)`` is written ``(C, 1, 1)``, a
PReLU slope ``(1, 1)``).

GTM8 is the full-integer artifact (:func:`export_native_weights_int8`, the
reference's int8 TFLite deployment): int8 weights per out-channel, then the
59 activation boundaries' params, in the layouts v1 (uniform 8 or 16 bits),
v2 (mixed), v3 (per-lane scales) and v4 (per-lane scales folded into the
weights, integer MACs).  Every scale is float32 throughout: a float64 step
would move a scale by an ulp and a weight by a quantum.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0x47544D31

# trailing singleton dims the JAX packed layout carries, by unpack key
_TRAILING = {"b": 2, "pw1_b": 2, "dw_b": 2, "pw2_b": 2, "pw3_b": 2,
             "tra_db": 1, "tra_pb": 1, "tra_dw": 1, "sfe_w": 2}


def _items(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v)
        else:
            yield k, v


def _packed(params) -> list[np.ndarray]:
    """The 158 packed tensors, float32 numpy in the JAX packed shapes.
    ``params`` may live on any device: they are packed on the host once."""
    from gtcrn_micro_tpu_torch.ops.fused_step import pack_weights, unpack

    out = []
    for key, t in _items(unpack(pack_weights(params, device="cpu"))):
        a = t.numpy()
        # the depthwise taps of the encoder GTConvs (9, C) and TCNs (3, C)
        # are (rows, C, 1, 1); the decoder's full 3x3 conv is 4-D already
        tail = 2 if key == "dw_w" and a.ndim == 2 else _TRAILING.get(key, 0)
        if a.ndim == 0:  # a PReLU slope is (1, 1)
            a = a.reshape(1)
            tail = 1
        out.append(np.ascontiguousarray(a.reshape(a.shape + (1,) * tail), np.float32))
    return out


def export_native_weights(params, path: str) -> int:
    """Serialize params (the nested dict of tensors or arrays) to ``path``
    as GTM1.  Returns the tensor count."""
    tensors = _packed(params)
    with open(path, "wb") as f:
        f.write(struct.pack("<II", MAGIC, len(tensors)))
        for t in tensors:
            f.write(struct.pack("<I", t.ndim))
            f.write(struct.pack(f"<{t.ndim}I", *t.shape))
            f.write(t.astype("<f4").tobytes())
    return len(tensors)


# ---------------------------------------------------------------------------
# GTM8: full-integer int8 artifact
# ---------------------------------------------------------------------------

MAGIC_INT8 = 0x47544D38  # "GTM8"

# Per-slot quantization: None = keep fp32, int = per-channel axis in the
# PACKED layout.  Biases, slopes and the frozen ERB filterbank stay fp32.
_GT_SLOT_AXES = [0, None, None, None, None, None, 0, None, 1, None, 0, None]
_GT_DW_AXIS_IDX = 3  # dw_w slot position inside a GTConv group
_TCN_SLOT_AXES = [0, None, None, 1, None, None, 0, None, None]


def _slot_axes() -> list:
    """Channel axis per packed slot (158 entries)."""
    axes: list = [None, None, 1]  # bm, bs, sfe (3, c, 1, 1) -> axis 1
    for _ in ("en0", "en1"):
        axes += [1, None, None]  # w (5, Co, Ci) -> axis 1
    for _ in range(3):  # encoder GTConv: dw (kt*kf, C, 1, 1) -> axis 1
        gt = list(_GT_SLOT_AXES)
        gt[_GT_DW_AXIS_IDX] = 1
        axes += gt
    for _ in range(8):
        axes += _TCN_SLOT_AXES
    for _ in range(3):  # decoder GTConv: dw (kt, kf, Co, Ci) -> axis 2
        gt = list(_GT_SLOT_AXES)
        gt[_GT_DW_AXIS_IDX] = 2
        axes += gt
    axes += [1, None, None]  # de3
    axes += [1, None]  # de4
    return axes


def act_path_order() -> list[str]:
    """The 59 activation-quant boundaries in graph order, the order the
    native int8 engines read them (``native/gtcrn_micro_q.cc``)."""
    gt = ("pw1/in", "depth_conv/in", "pw2/in", "tra/energy", "tra/gate_in")
    order = ["sfe/depth_conv/in", "encoder/en0/conv/in", "encoder/en1/conv/in"]
    for n in ("en2", "en3", "en4"):
        order += [f"encoder/{n}/{x}" for x in gt]
    for s in ("gtcn1", "gtcn2"):
        for j in range(4):
            order += [f"{s}/block{j}/{x}" for x in ("pw1/in", "conv2/in", "pw3/in")]
    for n in ("de0", "de1", "de2"):
        order += [f"decoder/{n}/{x}" for x in gt]
    order += ["decoder/de3/conv/in", "decoder/de4/conv/in"]
    return order


def _slot_fold_info() -> list:
    """(act_path, fold_axis) per packed slot: the boundary whose per-lane
    activation scales fold into this weight in the v4 artifact, and the
    packed axis that contracts against those lanes (the in-channel axis of a
    mixing conv, the channel axis of a depthwise one).  (None, None) for the
    fp32, bias and slope slots."""
    none = (None, None)
    info: list = [none, none]  # bm, bs
    info += [("sfe/depth_conv/in", 1)]  # (3, c, 1, 1) depthwise
    for n in ("en0", "en1"):
        info += [(f"encoder/{n}/conv/in", 2), none, none]  # (5, Co, Ci)

    def gt(prefix: str, dw_fold: int) -> list:
        return [
            (prefix + "pw1/in", 1), none, none,        # pw1_w (Co, Ci)
            (prefix + "depth_conv/in", dw_fold), none, none,
            (prefix + "pw2/in", 1), none,              # pw2_w (Co, Ci)
            (prefix + "tra/energy", 1), none,          # tra_dw (3, C, 1)
            (prefix + "tra/gate_in", 1), none,         # tra_pw (Co, Ci)
        ]

    for n in ("en2", "en3", "en4"):
        info += gt(f"encoder/{n}/", 1)  # encoder dw (9, C, 1, 1) depthwise
    for s in ("gtcn1", "gtcn2"):
        for j in range(4):
            p = f"{s}/block{j}/"
            info += [(p + "pw1/in", 1), none, none,
                     (p + "conv2/in", 1), none, none,  # dw (3, C, 1, 1)
                     (p + "pw3/in", 1), none, none]
    for n in ("de0", "de1", "de2"):
        info += gt(f"decoder/{n}/", 3)  # decoder dw (3, 3, Co, Ci) full conv
    info += [("decoder/de3/conv/in", 2), none, none]
    info += [("decoder/de4/conv/in", 2), none]
    return info


def _fold_act_scales(t: np.ndarray, scale: np.ndarray, axis: int) -> np.ndarray:
    """Multiply the weight's in-lane axis by the boundary's activation
    scales, in float32 (as ``quant.ptq.FakeQuantizerV4``)."""
    s = np.atleast_1d(np.asarray(scale, np.float32)).ravel()
    if s.size == 1:
        return (t * s[0]).astype(np.float32)
    if t.shape[axis] != s.size:
        raise ValueError(f"fold axis {axis} of {t.shape} != {s.size} lanes")
    shape = [1] * t.ndim
    shape[axis] = s.size
    return (t.astype(np.float32) * s.reshape(shape)).astype(np.float32)


def _quantize_per_channel(t: np.ndarray, axis: int):
    """Symmetric per-channel int8 (TFLite's), bit for bit
    ``quant.fake_quant.weight_qparams``: float32 throughout."""
    t = t.astype(np.float32)
    red = tuple(i for i in range(t.ndim) if i != axis)
    amax = np.max(np.abs(t), axis=red)
    scale = np.maximum((amax / np.float32(127.0)).astype(np.float32), np.float32(1e-12))
    shape = [1] * t.ndim
    shape[axis] = t.shape[axis]
    q = np.clip(np.rint(t / scale.reshape(shape)), -128, 127).astype(np.int8)
    return q, scale


def _host_qparams(act_qp: dict) -> dict:
    """path -> (scale float32 numpy, zero numpy, qmax), read from the port's
    ``QParams`` (tensors on any device) once."""
    def arr(v):
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    return {p: (arr(qp.scale).astype(np.float32), arr(qp.zero), int(qp.qmax))
            for p, qp in act_qp.items()}


def export_native_weights_int8(params, act_qp: dict, path: str,
                               integer_pc: bool = False) -> int:
    """Serialize the full-integer quantized artifact (GTM8).

    ``act_qp``: path -> ``quant.fake_quant.QParams`` from calibration
    (``quant.ptq.qparams_from_ranges``).  8-bit params give the full-int8
    artifact, 16-bit the 16x8 mode (int16 activations, int8 weights); a
    MIXED ``act_qp`` (some boundaries 8, some 16 bits) gives the v2 layout:
    header act_bits 0 and each boundary's bits before its params, run by the
    native int16 engine.  Weights are folded then quantized per out-channel,
    TFLite's order, which the native integer kernels execute.  Per-lane
    activation scales give the v3 layout (act_bits 1, per-boundary lane
    vectors; the float-MAC PC engine); ``integer_pc=True`` gives v4
    (act_bits 2): each int8 weight is quantized on its act-scale-folded
    tensor, so the per-lane grid runs on integer MACs
    (``native/gtcrn_micro_v4.cc``; the simulation is
    ``quant.ptq.QuantizedModel(v4=True)``).  Returns the tensor count."""
    tensors = _packed(params)
    axes = _slot_axes()
    order = act_path_order()
    missing = [p for p in order if p not in act_qp]
    if missing:
        raise KeyError(f"act_qp missing paths: {missing[:3]}...")
    qps = _host_qparams({p: act_qp[p] for p in order})

    def bits_of(p: str) -> int:
        qmax = qps[p][2]
        if qmax == 127:
            return 8
        if qmax == 32767:
            return 16
        raise ValueError(f"unsupported act qmax {qmax} at {p}")

    per_bits = [bits_of(p) for p in order]
    uniform = len(set(per_bits)) == 1
    per_channel = any(np.size(qps[p][0]) > 1 for p in order)
    # header act_bits: 8/16 uniform (v1), 0 mixed (v2), 1 per-lane (v3),
    # 2 per-lane on integer MACs (v4)
    act_bits = 1 if per_channel else (per_bits[0] if uniform else 0)
    fold_info = None
    if integer_pc:
        act_bits = 2
        fold_info = _slot_fold_info()

    with open(path, "wb") as f:
        f.write(struct.pack("<II", MAGIC_INT8, len(tensors)))
        for i, (t, axis) in enumerate(zip(tensors, axes)):
            f.write(struct.pack("<I", t.ndim))
            f.write(struct.pack(f"<{t.ndim}I", *t.shape))
            if axis is None:
                f.write(struct.pack("<I", 0))
                f.write(t.astype("<f4").tobytes())
                continue
            if fold_info is not None:
                act_path, fold_axis = fold_info[i]
                t = _fold_act_scales(t, qps[act_path][0], fold_axis)
            q, scale = _quantize_per_channel(t, axis)
            f.write(struct.pack("<II", 1, len(scale)))
            f.write(scale.astype("<f4").tobytes())
            f.write(q.tobytes())
        f.write(struct.pack("<II", act_bits, len(order)))
        for p, bits in zip(order, per_bits):
            scale, zero, _ = qps[p]
            if per_channel or integer_pc:  # v3/v4: bits, lanes, scales, zeros
                s = np.atleast_1d(scale).ravel()
                z = np.broadcast_to(np.atleast_1d(zero).ravel(), s.shape).astype(np.int32)
                f.write(struct.pack("<II", bits, len(s)))
                f.write(s.astype("<f4").tobytes())
                f.write(z.astype("<i4").tobytes())
            else:
                if not uniform:
                    f.write(struct.pack("<I", bits))
                f.write(struct.pack("<fi", float(scale.reshape(-1)[0]),
                                    int(np.reshape(zero, -1)[0])))
    return len(tensors)


def load_native_weights(path: str) -> list[np.ndarray]:
    """Read a GTM1 file back (round-trip checks)."""
    out = []
    with open(path, "rb") as f:
        magic, count = struct.unpack("<II", f.read(8))
        if magic != MAGIC:
            raise ValueError(f"{path}: bad magic {magic:#x}")
        for _ in range(count):
            (rank,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{rank}I", f.read(4 * rank))
            n = int(np.prod(dims)) if dims else 1
            out.append(np.frombuffer(f.read(4 * n), "<f4").reshape(dims))
    return out
